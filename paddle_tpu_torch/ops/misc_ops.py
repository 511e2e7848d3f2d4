"""Miscellaneous op lowerings closing the layers/nn.py tail: the port of
paddle_tpu/ops/misc_ops.py, all 34 of its ops.

Each is plain torch math, as each is plain jnp / lax there (the JAX
package computes none of them in a Pallas kernel). Where the JAX
lowering ``vmap``s a per-row function (``grid_sampler``,
``sequence_scatter``, ``psroi_pool``, ``roi_perspective_transform``,
``generate_mask_labels``, ``tree_conv``, ``similarity_focus``'s
``fori_loop`` over picks), the port computes the batch at once with
flat gathers and fixed-order adds (``tensor_ops.add_rows``), so a step
repeats bitwise on the card. The 3-D ops follow ``pool2d`` and the
convolutions: max pools pad with -inf, avg pools divide as the JAX
lowering does, and ``conv3d_transpose`` runs under ``nn._conv_flags``.
``hash_op`` mixes in int64 masked to 32 bits, every bit the JAX
package's uint32 arithmetic. The random ops (``random_crop``,
``gaussian_random_batch_size_like``,
``sampled_softmax_with_cross_entropy``) draw from the port's generator
chain (ROADMAP's RNG rule: held by their properties, and bitwise within
the port). ``sampled_softmax_with_cross_entropy`` has no gradient in
either package: its generic grad re-runs the forward, which draws, in a
context without RNG (ROADMAP C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_grad_lowering, register_op
from .basic import _dt
from .nn import _conv_flags
from .tensor_ops import _fill_value, add_rows, bounded_index

_SELU_SCALE = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: a zero row for an index outside [0, n)."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).to(dtype)


def _batched_add(n, idx, rows):
    """zeros [B, n, ...] with ``rows`` [B, E, ...] added at ``idx`` [B, E]
    along dim 1, repeated indices in a fixed order (``add_rows``); an
    index outside [-n, n) is dropped and a negative one wraps (JAX's
    ``.at[].add``)."""
    b, e = idx.shape
    safe, valid = bounded_index(idx, n)
    base = torch.arange(b, device=idx.device)[:, None] * n
    flat = torch.where(valid, base + safe, b * n).reshape(-1)
    tail = tuple(rows.shape[2:])
    out = add_rows(torch.zeros((b * n + 1,) + tail, dtype=rows.dtype,
                               device=rows.device),
                   flat, rows.reshape((b * e,) + tail))
    return out[:b * n].reshape((b, n) + tail)


def _gather_hw(img, yy, xx):
    """``img`` [N, C, H, W] at integer-valued float coords ``yy`` / ``xx``
    [N, Ho, Wo]: [N, C, Ho, Wo], zero where a coordinate lies outside
    the image (the JAX lowerings' per-row ``gather``, batched)."""
    n, c, h, w = img.shape
    inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    yc = yy.clamp(0, h - 1).long()
    xc = xx.clamp(0, w - 1).long()
    idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
    v = img.reshape(n, c, h * w).gather(2, idx).reshape(
        (n, c) + tuple(yy.shape[1:]))
    return torch.where(inb[:, None], v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))


def _bilinear(img, py, px):
    """Bilinear samples of ``img`` [N, C, H, W] at float coords [N, Ho,
    Wo], zero outside (the JAX lowerings' four-corner sum, in its
    order)."""
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    dy = (py - y0)[:, None]
    dx = (px - x0)[:, None]
    return (_gather_hw(img, y0, x0) * (1 - dy) * (1 - dx)
            + _gather_hw(img, y0, x0 + 1) * (1 - dy) * dx
            + _gather_hw(img, y0 + 1, x0) * dy * (1 - dx)
            + _gather_hw(img, y0 + 1, x0 + 1) * dy * dx)


@register_op("selu", diff_inputs=["X"])
def _selu(ctx, ins, attrs):
    """selu_op.cc: scale * (max(0,x) + min(0, alpha*(exp(x)-1)))."""
    x = ins["X"][0]
    scale = float(attrs.get("scale", _SELU_SCALE))
    alpha = float(attrs.get("alpha", _SELU_ALPHA))
    return {"Out": [scale * torch.where(x > 0, x,
                                        alpha * (torch.exp(x) - 1.0))]}


@register_op("multiplex", diff_inputs=["X"])
def _multiplex(ctx, ins, attrs):
    """multiplex_op.cc: out[i] = X[ids[i]][i], a row-wise candidate
    select (an id is wrapped and clamped, as a JAX gather's)."""
    xs = torch.stack(ins["X"], dim=0)         # [C, B, ...]
    ids, _ = bounded_index(ins["Ids"][0].reshape(-1), xs.shape[0])
    rows = torch.arange(xs.shape[1], device=xs.device)
    return {"Out": [xs[ids, rows]]}


@register_op("space_to_depth", diff_inputs=["X"])
def _space_to_depth(ctx, ins, attrs):
    """space_to_depth_op.cc: NCHW [N,C,H,W] -> [N, C*b*b, H/b, W/b]."""
    x = ins["X"][0]
    b = int(attrs["blocksize"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [x.reshape(n, c * b * b, h // b, w // b)]}


@register_op("shuffle_channel", diff_inputs=["X"])
def _shuffle_channel(ctx, ins, attrs):
    """shuffle_channel_op.cc: group-interleave channels."""
    x = ins["X"][0]
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    x = x.reshape(n, g, c // g, h, w).permute(0, 2, 1, 3, 4)
    return {"Out": [x.reshape(n, c, h, w)]}


@register_op("pad_constant_like", diff_inputs=["Y"])
def _pad_constant_like(ctx, ins, attrs):
    """pad_constant_like_op.cc: pad Y at the end to X's shape."""
    x, y = ins["X"][0], ins["Y"][0]
    val = float(attrs.get("pad_value", 0.0))
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(xs - ys)]
    return {"Out": [F.pad(y, pads, value=val)]}


@register_op("dice_loss_op", diff_inputs=["X"])
def _dice_loss(ctx, ins, attrs):
    """nn.py dice_loss composition: 1 - 2*|p∩l| / (|p|+|l|)."""
    x = ins["X"][0]
    label = ins["Label"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    lab = _one_hot(label.reshape(label.shape[:-1]), x.shape[-1], x.dtype)
    dims = tuple(range(1, x.dim()))
    inter = torch.sum(x * lab, dim=dims)
    union = torch.sum(x, dim=dims) + torch.sum(lab, dim=dims)
    return {"Out": [torch.mean(1.0 - (2.0 * inter + eps) / (union + eps))]}


@register_op("mean_iou", no_grad=True)
def _mean_iou(ctx, ins, attrs):
    """mean_iou_op.cc: mean intersection-over-union over classes."""
    pred = ins["Predictions"][0].reshape(1, -1)
    label = ins["Labels"][0].reshape(1, -1)
    n = int(attrs["num_classes"])
    ones = torch.ones(pred.shape + (1,), dtype=torch.float32,
                      device=pred.device)
    count = lambda idx: _batched_add(n, idx, ones)[0, :, 0]  # noqa: E731
    inter = count(torch.where(pred == label, pred.long(), n))
    pred_c = count(pred)
    lab_c = count(label)
    union = pred_c + lab_c - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0),
                      torch.zeros((), device=union.device))
    miou = torch.sum(iou) / torch.clamp(torch.sum(valid.to(torch.float32)),
                                        min=1.0)
    return {"OutMeanIou": [miou],
            "OutWrong": [(lab_c - inter).to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


@register_op("add_position_encoding", diff_inputs=["X"])
def _add_position_encoding(ctx, ins, attrs):
    """add_position_encoding_op.cc: alpha*x + beta*sincos_pe, x [B,T,D]."""
    x = ins["X"][0]
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    half = d // 2
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return {"Out": [alpha * x + beta * pe[None].to(x.dtype)]}


@register_op("bilinear_tensor_product", diff_inputs=["X", "Y", "Weight",
                                                     "Bias"])
def _bilinear_tensor_product(ctx, ins, attrs):
    """bilinear_tensor_product_op.cc: out_k = x W_k y^T + b_k."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    b = (ins.get("Bias") or [None])[0]
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if b is not None:
        out = out + b
    return {"Out": [out]}


@register_op("lstm_unit", diff_inputs=["X", "C_prev"])
def _lstm_unit(ctx, ins, attrs):
    """One cell step from pre-projected gates [B, 4D] (order i, f, c, o)
    with ``forget_bias``."""
    x = ins["X"][0]
    c_prev = ins["C_prev"][0]
    fb = float(attrs.get("forget_bias", 0.0))
    i, f, c, o = torch.chunk(x, 4, dim=-1)
    new_c = c_prev * torch.sigmoid(f + fb) + torch.sigmoid(i) * torch.tanh(c)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return {"C": [new_c], "H": [new_h]}


@register_op("is_empty", no_grad=True)
def _is_empty(ctx, ins, attrs):
    """Whether X has no elements: known from its static shape, so no
    host read."""
    x = ins["X"][0]
    return {"Out": [torch.full((1,), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register_op("print_op", diff_inputs=["X"], host_sync=True)
def _print_op(ctx, ins, attrs):
    """The Print layer: the value is read on the host and printed as the
    step runs (the JAX package prints from inside its compiled step with
    ``jax.debug.print``). The read is a host sync, so a step holding it
    runs uncaptured (core/executor.py)."""
    x = ins["X"][0]
    msg = attrs.get("message") or ""
    name = attrs.get("name") or ""
    print(msg + " " + name + " = " + str(x.detach().cpu().numpy()))
    return {"Out": [x]}


@register_grad_lowering("print_op")
def _print_op_grad(ctx, ins, attrs):
    """The identity's grad, without a second print (the generic grad
    would run the forward again under ``torch.func.vjp``, whose wrapped
    tensors have no host copy)."""
    g = (ins.get("Out@GRAD") or [None])[0]
    x = ins["X"][0]
    if g is None:
        g = torch.zeros_like(x)
    elif g.dtype != x.dtype or g.shape != x.shape:
        g = torch.broadcast_to(g.to(x.dtype), x.shape)
    return {"X@GRAD": [g]}


@register_op("teacher_student_sigmoid_loss", diff_inputs=["X"])
def _tssl(ctx, ins, attrs):
    """teacher_student_sigmoid_loss_op.cc: sce(x, z) + sce(x, z') with
    the encoded label convention (-2/-1 = no teacher, clk 0/1;
    [0,1)=teacher z' clk 0; [1,2]=1+z' clk 1)."""
    x = ins["X"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).to(torch.float32)

    def sce(v, z):
        return torch.clamp(v, min=0.0) - v * z + torch.log1p(
            torch.exp(-torch.abs(v)))

    one, zero = torch.ones_like(label), torch.zeros_like(label)
    z = torch.where(label <= -1.0,
                    torch.where(label <= -2.0 + 1e-6, zero, one),
                    torch.where(label < 1.0, zero, one))
    teacher = torch.where(label < -1.0 + 1e-6, zero,
                          torch.where(label < 1.0, label, label - 1.0))
    loss = sce(x, z) + torch.where(label >= 0.0, sce(x, teacher),
                                   torch.zeros_like(x))
    return {"Y": [loss[:, None]]}


@register_op("npair_loss_op", diff_inputs=["Anchor", "Positive"])
def _npair_loss(ctx, ins, attrs):
    """nn.py npair_loss composition: softmax CE over anchor-positive
    similarities + l2 regularization."""
    a = ins["Anchor"][0]
    p = ins["Positive"][0]
    labels = ins["Labels"][0].reshape(-1).to(torch.float32)
    reg = float(attrs.get("l2_reg", 0.002))
    sim = a @ p.T                                  # [B, B]
    same = (labels[:, None] == labels[None, :]).to(torch.float32)
    tgt = same / torch.clamp(torch.sum(same, dim=1, keepdim=True), min=1.0)
    ce = -torch.mean(torch.sum(tgt * torch.log_softmax(sim, dim=1), dim=1))
    l2 = torch.mean(torch.sum(a * a, dim=1) + torch.sum(p * p, dim=1)) * reg
    return {"Out": [ce + l2]}


@register_op("gaussian_random_batch_size_like", no_grad=True, uses_rng=True)
def _grbsl(ctx, ins, attrs):
    """``mean + std * N(0, 1)`` of ``shape``, its ``output_dim_idx`` dim
    the input's ``input_dim_idx`` dim, drawn from the port's chain."""
    x = ins["Input"][0]
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = x.shape[
        int(attrs.get("input_dim_idx", 0))]
    mean = float(attrs.get("mean", 0.0))
    std = float(attrs.get("std", 1.0))
    z = torch.randn(tuple(shape), generator=ctx.next_rng(),
                    dtype=torch.float32, device=ctx.device)
    return {"Out": [(mean + std * z).to(_dt(attrs))]}


@register_op("random_crop", no_grad=True, uses_rng=True)
def _random_crop(ctx, ins, attrs):
    """random_crop_op.cc: one random crop of the trailing dims to
    ``shape`` (every example at the same offsets, as the JAX lowering
    draws them), the offsets uniform over each dim's slack and kept on
    the device."""
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    nd = len(shape)
    lead = x.dim() - nd
    u = torch.rand((nd,), generator=ctx.next_rng(), device=ctx.device)
    offs = [(u[i] * float(x.shape[lead + i] - shape[i] + 1)).to(torch.int64)
            for i in range(nd)]
    out = x
    for i in range(nd):
        idx = offs[i].to(x.device) + torch.arange(shape[i], device=x.device)
        out = torch.index_select(out, lead + i, idx)
    return {"Out": [out]}


@register_op("increment_counter", no_grad=True)
def _increment_counter(ctx, ins, attrs):
    """autoincreased_step_counter backing op: counter += step."""
    return {"Out": [ins["X"][0] + int(attrs.get("step", 1))]}


def _triple(v):
    return tuple(int(t) for t in v)


@register_op("pool3d", diff_inputs=["X"])
def _pool3d(ctx, ins, attrs):
    """pool_op.cc 3-D variant: NCDHW max / avg pooling, ``pool2d``'s rules
    (max pads with -inf; avg divides by the count of real elements only
    when ``exclusive`` is set and a pad is non-zero, else by the window's
    size)."""
    x = ins["X"][0]
    k = _triple(attrs.get("ksize", [2, 2, 2]))
    s = _triple(attrs.get("strides", [1, 1, 1]))
    p = _triple(attrs.get("paddings", [0, 0, 0]))
    if attrs.get("global_pooling", False):
        k, s, p = tuple(x.shape[2:]), (1, 1, 1), (0, 0, 0)
    pad6 = (p[2], p[2], p[1], p[1], p[0], p[0])
    if attrs.get("pooling_type", "max") == "max":
        xp = F.pad(x, pad6, value=float("-inf"))
        return {"Out": [F.max_pool3d(xp, k, s)]}

    def window_sum(v):
        return F.avg_pool3d(F.pad(v, pad6), k, s, divisor_override=1)

    tot = window_sum(x)
    if attrs.get("exclusive", True) and any(p):
        return {"Out": [tot / window_sum(torch.ones_like(x))]}
    return {"Out": [tot / (k[0] * k[1] * k[2])]}


@register_op("adaptive_pool3d", diff_inputs=["X"])
def _adaptive_pool3d(ctx, ins, attrs):
    """pool_op.cc adaptive 3-D: the output's spatial dims fixed, by even
    splitting (the sizes must divide, the common use)."""
    x = ins["X"][0]
    od, oh, ow = [int(v) for v in attrs["ksize"]]
    n, c, d, h, w = x.shape
    x6 = x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
    red = (3, 5, 7)
    if attrs.get("pooling_type", "max") == "max":
        return {"Out": [torch.amax(x6, dim=red)]}
    return {"Out": [torch.mean(x6, dim=red)]}


def _conv3d_transpose(x, w, attrs):
    """conv_transpose_op.cc 3-D: Paddle's [Cin, Cout, KD, KH, KW] filter
    is torch's transposed-conv layout; out = (in - 1) * s + k - 2p, the
    JAX package's size (dilations and ``output_size`` are not read
    there either)."""
    return F.conv_transpose3d(x, w, None,
                              _triple(attrs.get("strides", [1, 1, 1])),
                              _triple(attrs.get("paddings", [0, 0, 0])))


@register_op("conv3d_transpose", diff_inputs=["Input", "Filter"])
def _conv3d_transpose_op(ctx, ins, attrs):
    with _conv_flags():
        return {"Out": [_conv3d_transpose(ins["Input"][0], ins["Filter"][0],
                                          attrs)]}


@register_grad_lowering("conv3d_transpose")
def _conv3d_transpose_grad(ctx, ins, attrs):
    """The vjp of the forward's call under the same cuDNN flags (the
    generic grad would run the backward outside them), as
    ``nn._register_conv``'s grads (whose ops write ``Output``, where this
    one writes ``Out``)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    g = ins["Out@GRAD"][0]
    with _conv_flags():
        out, vjp = torch.func.vjp(
            lambda a, b: _conv3d_transpose(a, b, attrs), x, w)
        dx, dw = vjp(g.to(out.dtype))
    return {"Input@GRAD": [dx], "Filter@GRAD": [dw]}


@register_op("ctc_greedy_decoder", no_grad=True)
def _ctc_greedy_decoder(ctx, ins, attrs):
    """ctc_align_op.cc greedy path, masked-dense: probs [B, T, C] +
    Length [B] -> argmax, collapse repeats, drop blanks; output padded
    with -1 plus decoded lengths, int32 (the device's int64)."""
    probs = ins["Input"][0]
    length = (ins.get("Length") or [None])[0]
    blank = int(attrs.get("blank", 0))
    b, t, _ = probs.shape
    ids = torch.argmax(probs, dim=-1).to(torch.int32)     # [B, T]
    t_idx = torch.arange(t, device=probs.device)[None, :]
    alive = t_idx < (length.reshape(-1, 1) if length is not None
                     else torch.full((b, 1), t, device=probs.device))
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int32,
                                 device=probs.device), ids[:, :-1]], dim=1)
    keep = alive & (ids != blank) & (ids != prev)
    # compact kept ids to the front, pad with -1
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compact = torch.gather(ids, 1, order)
    nkeep = torch.sum(keep, dim=1)
    out = torch.where(t_idx < nkeep[:, None], compact,
                      torch.full_like(compact, -1))
    return {"Out": [out], "OutLength": [nkeep.to(torch.int32)]}


@register_op("spectral_norm", diff_inputs=["Weight"])
def _spectral_norm(ctx, ins, attrs):
    """spectral_norm_op.cc: weight / sigma_max by power iteration on the
    [dim, -1] reshape. ``U`` is persistent state warmed across steps
    (UOut); the gradient flows through the weight only (u, v
    detached)."""
    w = ins["Weight"][0]
    u_state = (ins.get("U") or [None])[0]
    dim = int(attrs.get("dim", 0))
    iters = int(attrs.get("power_iters", 1))
    eps = float(attrs.get("eps", 1e-12))
    perm = (dim,) + tuple(i for i in range(w.dim()) if i != dim)
    mat = w.permute(perm).reshape(w.shape[dim], -1)          # [H, W]

    def norm(v):
        return v / (torch.linalg.vector_norm(v) + eps)

    u = (norm(torch.ones((mat.shape[0],), dtype=mat.dtype,
                         device=mat.device))
         if u_state is None else u_state)
    fixed = mat.detach()
    for _ in range(max(iters, 1)):
        v = norm(fixed.T @ u)
        u = norm(fixed @ v)
    u = u.detach()
    v = v.detach()
    sigma = u @ mat @ v
    return {"Out": [w / sigma], "UOut": [u]}


@register_op("affine_grid", diff_inputs=["Theta"])
def _affine_grid(ctx, ins, attrs):
    """affine_grid_op.cc: theta [N, 2, 3] -> sampling grid [N, H, W, 2]
    over the [-1, 1] normalized output lattice."""
    theta = ins["Theta"][0]
    h, w = [int(v) for v in attrs["output_shape"]][-2:]
    ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")            # [H, W]
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return {"Output": [torch.einsum("hwk,nck->nhwc",
                                    base.to(theta.dtype), theta)]}


@register_op("grid_sampler", diff_inputs=["X", "Grid"])
def _grid_sampler(ctx, ins, attrs):
    """grid_sample_op.cc: bilinear samples of x [N,C,H,W] at grid
    [N,Ho,Wo,2] ([-1,1] normalized, zero padding outside), the batch at
    once."""
    x = ins["X"][0]
    grid = ins["Grid"][0]
    _, _, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0     # [N, Ho, Wo]
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    return {"Output": [_bilinear(x, gy, gx)]}


@register_op("sequence_scatter", diff_inputs=["X", "Updates"])
def _sequence_scatter(ctx, ins, attrs):
    """sequence_scatter_op.cc, masked-dense: out = X; for each batch row
    b and step t < len[b]: out[b, index[b, t]] += updates[b, t], the
    adds of a row in a fixed order."""
    x = ins["X"][0]                          # [B, D]
    idx = ins["Ids"][0]                      # [B, T]
    upd = ins["Updates"][0]                  # [B, T]
    length = (ins.get("Length") or [None])[0]
    b, t = idx.shape
    if length is not None:
        mask = torch.arange(t, device=idx.device)[None, :] \
            < length.reshape(-1, 1)
        upd = torch.where(mask, upd, torch.zeros_like(upd))
    return {"Out": [x + _batched_add(x.shape[1], idx, upd)]}


@register_op("data_norm", diff_inputs=["X"])
def _data_norm(ctx, ins, attrs):
    """data_norm_op.cc: normalize by running batch statistics
    (batch_sum / batch_size, no learned affine); the accumulators update
    as the reference's CTR usage does."""
    x = ins["X"][0]
    bsize = ins["BatchSize"][0]
    bsum = ins["BatchSum"][0]
    bsq = ins["BatchSquareSum"][0]
    eps = float(attrs.get("epsilon", 1e-4))
    mean = bsum / bsize
    var = torch.clamp(bsq / bsize - mean * mean, min=eps)
    out = (x - mean) / torch.sqrt(var)
    return {"Y": [out], "BatchSizeOut": [bsize + x.shape[0]],
            "BatchSumOut": [bsum + torch.sum(x, dim=0)],
            "BatchSquareSumOut": [bsq + torch.sum(x * x, dim=0)],
            "Means": [mean], "Scales": [1.0 / torch.sqrt(var)]}


@register_op("sampled_softmax_with_cross_entropy", diff_inputs=["Logits"],
             uses_rng=True)
def _sampled_softmax(ctx, ins, attrs):
    """sampled_softmax_with_cross_entropy_op.cc: softmax CE over the true
    class + num_samples uniformly sampled negatives with the
    log-probability correction."""
    logits = ins["Logits"][0]          # [B, V]
    label = ins["Label"][0].reshape(-1).long()
    s = int(attrs.get("num_samples", 100))
    b, v = logits.shape
    neg = torch.randint(0, v, (b, s), generator=ctx.next_rng(),
                        device=ctx.device).to(logits.device)
    cols = torch.cat([label[:, None], neg], dim=1)   # [B, 1+S]
    picked = torch.gather(logits, 1, cols)
    # uniform proposal correction: q = S / V per sampled class
    logq = torch.log(torch.full((b, s), s / v, dtype=picked.dtype,
                                device=picked.device))
    adj = picked - torch.cat(
        [torch.zeros((b, 1), dtype=picked.dtype, device=picked.device),
         logq], dim=1)
    # mask accidental true-class hits among the negatives
    hit = cols[:, 1:] == label[:, None]
    adj = torch.cat([adj[:, :1], torch.where(
        hit, torch.full_like(adj[:, 1:], -1e9), adj[:, 1:])], dim=1)
    return {"Loss": [-torch.log_softmax(adj, dim=1)[:, :1]]}


_U32 = 0xFFFFFFFF


@register_op("hash_op", no_grad=True)
def _hash_op(ctx, ins, attrs):
    """hash_op.cc's API shape: ids [N, T] -> [N, T, num_hash] bucketed
    hashes, the JAX package's multiplicative mixer (not xxhash): its
    uint32 arithmetic computed in int64 masked to 32 bits, so every bit
    is the JAX package's."""
    x = ins["X"][0].to(torch.int64) & _U32
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 1))
    k = torch.arange(num_hash, dtype=torch.int64, device=x.device)
    primes = (2654435761 + 40503 * k) & _U32
    offsets = (k * 2246822519) & _U32
    mixed = ((x[..., None] * primes & _U32) + offsets) & _U32
    mixed = mixed ^ (mixed >> 15)
    return {"Out": [(mixed % (mod_by & _U32)).to(torch.int32)]}


@register_op("psroi_pool", diff_inputs=["X"])
def _psroi_pool(ctx, ins, attrs):
    """psroi_pool_op.cc: position-sensitive average ROI pooling: bin
    (i, j) of output channel c averages input channel c*ph*pw + i*pw + j
    over that bin's spatial extent, every roi and bin at once."""
    x = ins["X"][0]                           # [B, C*ph*pw, H, W]
    rois = ins["ROIs"][0].to(torch.float32)   # [N, 4]
    roi_batch = (ins.get("RoisBatch") or [None])[0]
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    out_c = int(attrs["output_channels"])
    scale = float(attrs.get("spatial_scale", 1.0))
    _, _, h, w = x.shape
    n = rois.shape[0]
    rb = (torch.zeros((n,), dtype=torch.int64, device=x.device)
          if roi_batch is None else roi_batch.long())
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    r = rois * scale
    x1, y1, x2, y2 = (r[:, k:k + 1] for k in range(4))       # [N, 1]
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    i = torch.arange(ph, dtype=torch.float32, device=dev)
    j = torch.arange(pw, dtype=torch.float32, device=dev)
    by1 = y1 + rh * i / ph                                    # [N, ph]
    by2 = y1 + rh * (i + 1) / ph
    bx1 = x1 + rw * j / pw                                    # [N, pw]
    bx2 = x1 + rw * (j + 1) / pw
    my = (ys >= torch.floor(by1)[..., None]) & (ys < torch.ceil(by2)[..., None])
    mx = (xs >= torch.floor(bx1)[..., None]) & (xs < torch.ceil(bx2)[..., None])
    m = my[:, :, None, :, None] & mx[:, None, :, None, :]   # [N,ph,pw,H,W]
    cnt = torch.clamp(m.sum(dim=(3, 4)), min=1)              # [N, ph, pw]
    img = x[rb].reshape(n, out_c, ph, pw, h, w)
    tot = torch.sum(torch.where(m[:, None], img, torch.zeros(
        (), dtype=img.dtype, device=dev)), dim=(4, 5))
    return {"Out": [tot / cnt[:, None]]}


@register_op("take_along_axis1", no_grad=True)
def _take_along_axis1(ctx, ins, attrs):
    """Batched row gather on dim 1 (detection sampling glue); an index
    outside [-n, n) takes ``jnp.take_along_axis``'s fill."""
    x = ins["X"][0]
    idx = ins["Index"][0]
    expanded = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    expanded = expanded.expand(tuple(idx.shape) + tuple(x.shape[2:]))
    safe, valid = bounded_index(expanded, x.shape[1])
    out = torch.gather(x, 1, safe)
    return {"Out": [torch.where(valid, out, torch.full_like(
        out, _fill_value(x.dtype)))]}


@register_op("similarity_focus", no_grad=True)
def _similarity_focus(ctx, ins, attrs):
    """similarity_focus_op.cc: per selected channel index, greedily pick
    row/column-exclusive maxima of T = X[:, idx] (min(B, C) picks, every
    example at once) and mark them 1; OR over indexes; broadcast over
    the focused axis. axis=1 (channel) is supported, the reference's
    documented use."""
    x = ins["X"][0]                          # [N, A, B, C]
    if int(attrs.get("axis", 1)) != 1:
        raise NotImplementedError("similarity_focus supports axis=1")
    indexes = [int(i) for i in attrs["indexes"]]
    n, _, bd, cd = x.shape
    rows = torch.arange(bd, device=x.device)[None, :, None]
    cols = torch.arange(cd, device=x.device)[None, None, :]
    ninf = float("-inf")
    m = None
    for idx in indexes:
        t = x[:, idx].to(torch.float32)
        mask = torch.zeros((n, bd, cd), dtype=torch.float32,
                           device=x.device)
        for _ in range(min(bd, cd)):
            flat = torch.argmax(t.reshape(n, -1), dim=1)
            i = torch.div(flat, cd, rounding_mode="floor")[:, None, None]
            j = (flat % cd)[:, None, None]
            mask = torch.where((rows == i) & (cols == j), 1.0, mask)
            t = torch.where((rows == i) | (cols == j), ninf, t)
        m = mask if m is None else torch.maximum(m, mask)
    return {"Out": [m[:, None].expand(x.shape).to(x.dtype)]}


def _quad_homography(quad):
    """[N, 8] quads (x1 y1 ... x4 y4, clockwise from top-left) -> [N, 3,
    3] homographies mapping the unit square's corners to each quad."""
    n = quad.shape[0]
    dst = quad.reshape(n, 4, 2)
    zero = torch.zeros((n,), dtype=quad.dtype, device=quad.device)
    one = torch.ones_like(zero)
    rows = []
    for i, (sx, sy) in enumerate(((0.0, 0.0), (1.0, 0.0), (1.0, 1.0),
                                  (0.0, 1.0))):
        dx, dy = dst[:, i, 0], dst[:, i, 1]
        rows.append(torch.stack([zero + sx, zero + sy, one, zero, zero,
                                 zero, -dx * sx, -dx * sy], dim=1))
        rows.append(torch.stack([zero, zero, zero, zero + sx, zero + sy,
                                 one, -dy * sx, -dy * sy], dim=1))
    a = torch.stack(rows, dim=1)                  # [N, 8, 8]
    # solve_ex: no host read of the factorization's status, so the op
    # can sit in a captured step
    h = torch.linalg.solve_ex(a, dst.reshape(n, 8))[0]
    return torch.cat([h, one[:, None]], dim=1).reshape(n, 3, 3)


@register_op("roi_perspective_transform", no_grad=True)
def _roi_perspective_transform(ctx, ins, attrs):
    """roi_perspective_transform_op.cc: bilinear-sample each
    quadrilateral ROI ([N, 8] corner coords) through its unit-square
    homography into a [transformed_height, transformed_width] patch,
    every roi at once."""
    x = ins["X"][0]                           # [B, C, H, W]
    rois = ins["ROIs"][0]                     # [N, 8]
    roi_batch = (ins.get("RoisBatch") or [None])[0]
    out_h = int(attrs["transformed_height"])
    out_w = int(attrs["transformed_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    n = rois.shape[0]
    dev = x.device
    rb = (torch.zeros((n,), dtype=torch.int64, device=dev)
          if roi_batch is None else roi_batch.long())
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")           # [oh, ow]
    unit = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [oh, ow, 3]
    hm = _quad_homography(rois.to(torch.float32) * scale)
    mapped = torch.einsum("hwk,njk->nhwj", unit, hm)          # [N, oh, ow, 3]
    px = mapped[..., 0] / mapped[..., 2]
    py = mapped[..., 1] / mapped[..., 2]
    return {"Out": [_bilinear(x[rb], py, px)]}


def _pairwise_iou_xyxy(a, b):
    """[..., G, 4] x [..., P, 4] -> [..., G, P] IoU (normalized xyxy)."""
    def area(t):
        return torch.clamp(t[..., 2] - t[..., 0], min=0) * torch.clamp(
            t[..., 3] - t[..., 1], min=0)

    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    return inter / torch.clamp(area(a)[..., :, None] + area(b)[..., None, :]
                               - inter, min=1e-10)


@register_op("generate_mask_labels", no_grad=True)
def _generate_mask_labels(ctx, ins, attrs):
    """generate_mask_labels_op.cc, the JAX package's dense bitmap
    redesign: gt segmentation arrives as per-gt BITMAP masks [B, G, Hm,
    Wm] over the image extent. For each sampled fg roi, the best-IoU
    gt's mask is crop-resized to resolution^2 (-1 marks non-fg rows),
    every image and roi at once."""
    rois = ins["Rois"][0]                     # [B, K, 4]
    labels = ins["LabelsInt32"][0]            # [B, K]
    gt = ins["GtBoxes"][0].to(torch.float32)  # [B, G, 4]
    segms = ins["GtSegms"][0].to(torch.float32)  # [B, G, Hm, Wm]
    res = int(attrs.get("resolution", 14))
    b, g, im_h, im_w = segms.shape
    k = labels.shape[1]
    dev = rois.device
    ys = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    xs = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    r = rois.to(torch.float32)
    valid = (gt[..., 2] - gt[..., 0] > 0) & (gt[..., 3] - gt[..., 1] > 0)
    iou = torch.where(valid[..., None], _pairwise_iou_xyxy(gt, r),
                      torch.zeros((), device=dev))             # [B, G, K]
    agt = torch.argmax(iou, dim=1)                             # [B, K]
    x0, y0, x1, y1 = (r[..., c, None, None] for c in range(4))  # [B,K,1,1]
    xi = torch.clamp(x0 + gx * (x1 - x0), 0, im_w - 1).to(torch.int64)
    yi = torch.clamp(y0 + gy * (y1 - y0), 0, im_h - 1).to(torch.int64)
    flat = (agt[..., None, None] * im_h + yi) * im_w + xi     # [B,K,res,res]
    m = torch.gather(segms.reshape(b, -1), 1, flat.reshape(b, -1))
    masks = torch.where((labels > 0).reshape(b, k, 1), m.reshape(b, k, -1),
                        torch.full((), -1.0, device=dev))
    return {"MaskRois": [rois],
            "RoiHasMaskInt32": [(labels > 0).to(torch.int32)],
            "MaskInt32": [masks]}


@register_op("tree_conv", diff_inputs=["NodesVector", "Filter"])
def _tree_conv(ctx, ins, attrs):
    """tree_conv_op.cc (TBCNN continuous binary tree conv), depth-2
    patches: each node's window is itself + its direct children, with
    the standard eta weights (top: 1 for the parent, 0 for children;
    left/right: child position interpolation). max_depth > 2 windows are
    not supported (the JAX package's documented subset). The batch at
    once, the children's adds in a fixed order."""
    nodes = ins["NodesVector"][0].to(torch.float32)  # [B, N, F]
    edges = ins["EdgeSet"][0].long()                 # [B, E, 2]
    w = ins["Filter"][0]                             # [F, 3, out, nf]
    bn, n, f = nodes.shape
    wt, wl, wr = w[:, 0], w[:, 1], w[:, 2]           # [F, out, nf]
    parent, child = edges[..., 0], edges[..., 1]     # [B, E]
    valid = (parent > 0) | (child > 0)               # 0,0 rows are padding
    ones = valid.to(torch.float32)
    cnt = _batched_add(n, parent, ones[..., None])[..., 0]        # [B, N]
    oh = _one_hot(parent, n, torch.float32)                       # [B,E,N]
    order = (torch.cumsum(oh * ones[..., None], dim=1) * oh).sum(dim=2)
    safe_p, _ = bounded_index(parent, n)
    n_sib = torch.clamp(torch.gather(cnt, 1, safe_p), min=1.0)
    eta_r = torch.where(n_sib > 1, (order - 1) / (n_sib - 1),
                        torch.full_like(n_sib, 0.5))
    eta_l = 1.0 - eta_r
    base = torch.arange(bn, device=nodes.device)[:, None] * n
    safe_c, _ = bounded_index(child, n)
    cx = nodes.reshape(bn * n, f)[base + safe_c]                  # [B, E, F]
    contrib = (torch.einsum("bef,fok->beok", cx, wl) * eta_l[..., None, None]
               + torch.einsum("bef,fok->beok", cx, wr)
               * eta_r[..., None, None])
    contrib = torch.where(valid[..., None, None], contrib,
                          torch.zeros((), device=nodes.device))
    agg = _batched_add(n, parent, contrib)                        # [B,N,o,k]
    return {"Out": [agg + torch.einsum("bnf,fok->bnok", nodes, wt)]}
