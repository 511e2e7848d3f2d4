"""NN ops: conv2d, depthwise_conv2d, conv2d_transpose, conv3d, pool2d,
pool2d_with_index, batch_norm, layer_norm, rms_norm, group_norm, lrn,
lookup_table (and lookup_table_v2), dropout, softmax, log_softmax,
cross_entropy, softmax_with_cross_entropy, label_smooth, the
regression and logistic losses (sigmoid_cross_entropy_with_logits,
square_error_cost, smooth_l1_loss, huber_loss, log_loss), maxout,
top_k, and im2sequence, which raises as in the JAX package.

Counterparts of paddle_tpu/ops/nn.py. Inference-mode dropout follows the
reference's ``downgrade_in_infer`` rule: the output is scaled by
(1 - p), so BERT's dropout 0.1 multiplies every activation it touches
by 0.9 at serving time.

Grad lowerings of their own: dropout (reuses the saved mask, as in the
JAX package), softmax_with_cross_entropy (the JAX package's closed
form), and lookup_table, whose rows are summed per id in a fixed order
(ops/tensor_ops.py ``scatter_add_rows``) so that a training step is
bitwise repeatable on CUDA. Its forward gathers by advanced indexing,
whose autograd backward (what a recompute segment's vjp takes) sums the
rows the same way. An id past the table's rows gives a NaN row and
takes no grad, as ``jnp.take`` and JAX's scatter do (ops/tensor_ops.py
``take_rows``).

The image ops follow the JAX lowerings, which differ from Fluid's C++
in places:

- ``conv2d`` (NCHW / OIHW, symmetric pads, dilations, groups) is one
  ``F.conv2d`` (``depthwise_conv2d`` the same with groups = channels by
  default, ``conv3d`` one ``F.conv3d``, ``conv2d_transpose`` one
  ``F.conv_transpose2d`` without groups, as in the JAX package): the
  JAX package's convolution is XLA's, outside any Pallas kernel, so
  cuDNN's stays. cuDNN's weight-grad algorithms may
  add with atomics, and ``benchmark`` mode picks algorithms per run,
  so the forward and its grad (a grad lowering of its own, the vjp of
  the same call) run under ``_conv_flags``: deterministic,
  non-benchmarked cuDNN without TF32, scoped to the op and set nowhere
  else, so a training step is bitwise repeatable and an f32 product
  stays f32. On an H100 the default flags (benchmark off) gave
  ResNet-50's 7 x 7 stem three different grads in three runs at batch
  32; the deterministic algorithms repeat, at 1.7 times that conv's
  time (chip_smoke.py phase 10's probe, PERF.md).
- ``pool2d`` takes no ``ceil_mode`` (the JAX lowering ignores it). Max
  pads with -inf (an integer input with its dtype's least value); avg
  divides by the count of real elements only when ``exclusive`` is set
  and a pad is non-zero, else by kh * kw, whatever the pads
  (``F.avg_pool2d``'s ``count_include_pad`` is another rule: the sums
  are taken over a padded copy with ``divisor_override=1``). The max
  grad routes a tie within a window to its first element in both
  packages.
- ``batch_norm`` normalizes by the batch's biased variance (ddof 0),
  updates the running stats as ``mean * momentum + batch * (1 -
  momentum)`` (the biased variance too), and saves the batch mean and
  variance (not Fluid's inverse std) in ``SavedMean`` /
  ``SavedVariance``; ``is_test`` or ``use_global_stats`` normalize by
  the running stats and pass them through. Its grad is the generic
  vjp.
- ``cross_entropy`` takes ``-log(p + 1e-8)``; a hard label in [-C, 0)
  wraps and one outside [-C, C) picks NaN, as ``take_along_axis``
  does; ``ignore_index`` gives 0.
- ``pool2d_with_index`` returns ``pool2d``'s max and Fluid's Mask (the
  flat H * W index of each window's first max), where the JAX lowering
  returns zeros; ``smooth_l1_loss`` applies InsideWeight /
  OutsideWeight when an op carries them (Fluid's rule; the JAX lowering
  reads neither, and no layer passes them).
- ``top_k`` puts the lower index first among equal values, as
  ``lax.top_k`` does (a stable descending sort, then the first k;
  ``torch.topk`` on CUDA promises no order among ties).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..core.lowering import rand_rows
from ..core.registry import register_grad_lowering, register_op
from .basic import weak_scalar
from .tensor_ops import bounded_index, scatter_add_rows, take_rows


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


# ------------------------------------------------------------------- conv
def _conv_flags():
    """cuDNN as the conv ops run it: deterministic algorithms, no
    benchmark search, no TF32; a no-op for CPU tensors."""
    if not torch.backends.cudnn.is_available():
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _conv(x, w, attrs):
    return F.conv2d(x, w, None, _pair(attrs.get("strides", [1, 1])),
                    _pair(attrs.get("paddings", [0, 0])),
                    _pair(attrs.get("dilations", [1, 1])),
                    attrs.get("groups", 1))


def _depthwise(x, w, attrs):
    return _conv(x, w, dict(attrs, groups=attrs.get("groups", x.shape[1])))


def _conv_transpose(x, w, attrs):
    """Paddle's (in, out / groups, kh, kw) filter is torch's transposed
    conv layout; out = (in - 1) * stride + dilation * (k - 1) + 1 - 2 *
    pad, the JAX package's size (``output_size`` is not read there
    either)."""
    if attrs.get("groups", 1) != 1:
        raise NotImplementedError(
            "conv2d_transpose with groups > 1 is not supported yet")
    return F.conv_transpose2d(x, w, None, _pair(attrs.get("strides", [1, 1])),
                              _pair(attrs.get("paddings", [0, 0])), 0, 1,
                              _pair(attrs.get("dilations", [1, 1])))


def _conv3d_fn(x, w, attrs):
    return F.conv3d(x, w, None, tuple(attrs.get("strides", [1, 1, 1])),
                    tuple(attrs.get("paddings", [0, 0, 0])),
                    tuple(attrs.get("dilations", [1, 1, 1])),
                    attrs.get("groups", 1))


def _register_conv(op_type, fn):
    """The op, and its grad lowering: the vjp of the forward's call,
    taken under the same cuDNN flags (the generic grad would run the
    backward outside them)."""

    @register_op(op_type, diff_inputs=["Input", "Filter"])
    def _fwd(ctx, ins, attrs):
        with _conv_flags():
            return {"Output": [fn(ins["Input"][0], ins["Filter"][0], attrs)]}

    @register_grad_lowering(op_type)
    def _grad(ctx, ins, attrs):
        x, w = ins["Input"][0], ins["Filter"][0]
        g = ins["Output@GRAD"][0]
        with _conv_flags():
            out, vjp = torch.func.vjp(lambda a, b: fn(a, b, attrs), x, w)
            dx, dw = vjp(g.to(out.dtype))
        return {"Input@GRAD": [dx], "Filter@GRAD": [dw]}


_register_conv("conv2d", _conv)
_register_conv("depthwise_conv2d", _depthwise)
_register_conv("conv2d_transpose", _conv_transpose)
_register_conv("conv3d", _conv3d_fn)


# ------------------------------------------------------------------- pool
@register_op("pool2d", diff_inputs=["X"])
def _pool2d(ctx, ins, attrs):
    x = ins["X"][0]
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ksize, strides, pads = (x.shape[2], x.shape[3]), (1, 1), (0, 0)
    pad4 = (pads[1], pads[1], pads[0], pads[0])
    if attrs.get("pooling_type", "max") == "max":
        if x.is_floating_point():
            xp = F.pad(x, pad4, value=float("-inf"))
            return {"Out": [F.max_pool2d(xp, ksize, strides)]}
        # integer pools: the dtype's least value pads (no grad)
        xp = F.pad(x, pad4, value=torch.iinfo(x.dtype).min)
        win = xp.unfold(2, ksize[0], strides[0]).unfold(3, ksize[1],
                                                         strides[1])
        return {"Out": [win.amax(dim=(-2, -1))]}

    def window_sum(v):
        return F.avg_pool2d(F.pad(v, pad4), ksize, strides,
                            divisor_override=1)

    s = window_sum(x)
    if attrs.get("exclusive", True) and pads != (0, 0):
        return {"Out": [s / window_sum(torch.ones_like(x))]}
    return {"Out": [s / (ksize[0] * ksize[1])]}


@register_op("pool2d_with_index", diff_inputs=["X"])
def _pool2d_with_index(ctx, ins, attrs):
    """Max pooling (``pool2d``'s) and Mask, the int32 flat index into
    the input's H * W of each window's max, the first among ties (a pad
    never wins over a real element)."""
    x = ins["X"][0]
    attrs = dict(attrs, pooling_type="max")
    out = _pool2d(ctx, {"X": [x]}, attrs)["Out"][0]
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ksize, strides, pads = (x.shape[2], x.shape[3]), (1, 1), (0, 0)
    H, W = x.shape[2], x.shape[3]
    xp = F.pad(x.detach(), (pads[1], pads[1], pads[0], pads[0]),
               value=float("-inf"))
    win = xp.unfold(2, ksize[0], strides[0]).unfold(3, ksize[1], strides[1])
    flat = win.reshape(tuple(win.shape[:4]) + (-1,))
    at = torch.argmax(flat, dim=-1)  # the first max, row-major
    oh = torch.arange(win.shape[2], device=x.device).reshape(-1, 1)
    ow = torch.arange(win.shape[3], device=x.device).reshape(1, -1)
    h = oh * strides[0] + torch.div(at, ksize[1], rounding_mode="floor") \
        - pads[0]
    w = ow * strides[1] + at % ksize[1] - pads[1]
    mask = h.clamp(0, H - 1) * W + w.clamp(0, W - 1)
    return {"Out": [out], "Mask": [mask.to(torch.int32)]}


# ------------------------------------------------------------------- norms
@register_op("batch_norm", diff_inputs=["X", "Scale", "Bias"])
def _batch_norm(ctx, ins, attrs):
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    caxis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != caxis)
    bshape = tuple(x.shape[caxis] if i == caxis else 1
                   for i in range(x.ndim))
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        use_mean = x.mean(dim=axes)
        use_var = x.var(dim=axes, unbiased=False)
        mean_out = mean * momentum + use_mean * (1 - momentum)
        var_out = var * momentum + use_var * (1 - momentum)
    inv = torch.rsqrt(use_var + eps)
    y = (x - use_mean.reshape(bshape)) * inv.reshape(bshape) * \
        scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [use_mean], "SavedVariance": [use_var]}


@register_op("layer_norm", diff_inputs=["X", "Scale", "Bias"])
def _layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    scale = ins.get("Scale", [None])[0]
    bias = ins.get("Bias", [None])[0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    bshape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return {"Y": [y], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}


@register_op("rms_norm", diff_inputs=["X", "Scale"])
def _rms_norm(ctx, ins, attrs):
    """Root-mean-square norm: statistics and rsqrt in f32, the result cast
    back to x's dtype, then times Scale (bf16 x f32 promotes to f32 in
    both packages). Its grad is the generic vjp."""
    x = ins["X"][0]
    scale = ins.get("Scale", [None])[0]
    eps = attrs.get("epsilon", 1e-6)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=axes, keepdim=True)
    y = (xf * torch.rsqrt(ms + eps)).to(x.dtype)
    if scale is not None:
        y = y * scale.reshape((1,) * begin + tuple(x.shape[begin:]))
    return {"Y": [y]}


@register_op("group_norm", diff_inputs=["X", "Scale", "Bias"])
def _group_norm(ctx, ins, attrs):
    """Normalize each of ``groups`` channel groups per sample by its
    mean and biased variance; Mean and Variance are [N, groups]."""
    x = ins["X"][0]
    scale = ins.get("Scale", [None])[0]
    bias = ins.get("Bias", [None])[0]
    groups = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.ndim - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return {"Y": [y], "Mean": [mean.reshape(n, groups)],
            "Variance": [var.reshape(n, groups)]}


@register_op("lrn", diff_inputs=["X"])
def _lrn(ctx, ins, attrs):
    """Across-channel local response norm of NCHW x: MidOut = k + alpha
    * the sum of squares over the n channels around each (zero beyond
    the edges), Out = x / MidOut ** beta."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    acc = sq[:, 0:x.shape[1]]
    for i in range(1, n):
        acc = acc + sq[:, i:i + x.shape[1]]
    mid = attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * acc
    return {"Out": [x / torch.pow(mid, attrs.get("beta", 0.75))],
            "MidOut": [mid]}


@register_op("lookup_table", diff_inputs=["W"])
def _lookup_table(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = take_rows(w, ids.reshape(-1)).reshape(tuple(ids.shape) +
                                                (w.shape[1],))
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out.masked_fill((ids == pad).unsqueeze(-1), 0.0)
    return {"Out": [out]}


@register_grad_lowering("lookup_table")
def _lookup_table_grad(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    flat = ids.reshape(-1).to(torch.int64)
    g = ins["Out@GRAD"][0].reshape(flat.shape[0], w.shape[1]).to(w.dtype)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        g = g.masked_fill((flat == pad).unsqueeze(-1), 0.0)
    return {"W@GRAD": [scatter_add_rows(w.shape, flat, g)]}


@register_op("lookup_table_v2", diff_inputs=["W"])
def _lookup_table_v2(ctx, ins, attrs):
    return _lookup_table(ctx, ins, attrs)


register_grad_lowering("lookup_table_v2")(_lookup_table_grad)


@register_op("dropout", diff_inputs=["X"], uses_rng=True)
def _dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        if impl == "upscale_in_train":
            return {"Out": [x], "Mask": [torch.ones_like(x)]}
        return {"Out": [x * weak_scalar(1.0 - p, x)],
                "Mask": [torch.ones_like(x)]}
    if attrs.get("fix_seed", False):
        gen = ctx.seeded_rng(int(attrs.get("seed", 0)))
    else:
        gen = ctx.next_rng()
    keep = rand_rows(ctx, x.shape, gen, x.device, "X") < (1.0 - p)
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        mask = mask / weak_scalar(max(1.0 - p, 1e-8), mask)
    return {"Out": [x * mask], "Mask": [mask]}


@register_grad_lowering("dropout")
def _dropout_grad(ctx, ins, attrs):
    return {"X@GRAD": [ins["Out@GRAD"][0] * ins["Mask"][0]]}


# ------------------------------------------------------------------- softmax
@register_op("softmax", diff_inputs=["X"])
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("log_softmax", diff_inputs=["X"])
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


@register_op("label_smooth", diff_inputs=["X"])
def _label_smooth(ctx, ins, attrs):
    """(1 - eps) * X + eps * PriorDist, or eps / K without a prior
    (the reference's label_smooth_op.cc)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    dist = (ins.get("PriorDist") or [None])[0]
    keep = weak_scalar(1.0 - eps, x) * x
    if dist is not None:
        return {"Out": [keep + weak_scalar(eps, dist) * dist.reshape(
            (1,) * (x.ndim - 1) + (-1,))]}
    return {"Out": [keep + weak_scalar(eps / x.shape[-1], x)]}


def _hard_label(label, ndim):
    if label.ndim == ndim and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return label.to(torch.int64)


@register_op("cross_entropy", diff_inputs=["X"])
def _cross_entropy(ctx, ins, attrs):
    """-log(p + 1e-8) of the label's probability (soft labels: their
    weighted sum), [N, 1] labels squeezed, ``ignore_index`` rows 0."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = weak_scalar(1e-8, x)
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(x + eps), dim=-1,
                                 keepdim=True)]}
    lbl = _hard_label(label, x.ndim)
    safe, valid = bounded_index(lbl, x.shape[-1])
    picked = torch.gather(x, -1, safe.unsqueeze(-1))
    picked = torch.where(valid.unsqueeze(-1), picked, float("nan"))
    loss = -torch.log(picked + eps)
    ignore = (lbl == attrs.get("ignore_index", -100)).unsqueeze(-1)
    return {"Y": [torch.where(ignore, torch.zeros_like(loss), loss)]}


@register_op("softmax_with_cross_entropy", diff_inputs=["Logits"])
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    sm = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        lbl = _hard_label(label, logits.ndim)
        ignore = attrs.get("ignore_index", -100)
        # an ignored label may lie outside [0, C): pick class 0 for it,
        # then zero its loss
        safe = torch.where(lbl == ignore, torch.zeros_like(lbl), lbl)
        loss = -torch.gather(logp, -1, safe.unsqueeze(-1))
        loss = torch.where((lbl == ignore).unsqueeze(-1),
                           torch.zeros_like(loss), loss)
    return {"Softmax": [sm], "Loss": [loss]}


@register_grad_lowering("softmax_with_cross_entropy")
def _softmax_with_cross_entropy_grad(ctx, ins, attrs):
    """Closed form d_logits = dloss * (softmax - onehot(label)), as in the
    JAX package (and the reference's CUDA kernel: an ignored label takes
    no -1, its row keeps dloss * softmax)."""
    sm = ins["Softmax"][0]
    label = ins["Label"][0]
    dloss = ins["Loss@GRAD"][0]
    if attrs.get("soft_label", False):
        return {"Logits@GRAD": [(sm - label) * dloss]}
    lbl = _hard_label(label, sm.ndim)
    inside = (lbl >= 0) & (lbl < sm.shape[-1])
    onehot = torch.zeros_like(sm).scatter_(
        -1, torch.where(inside, lbl, torch.zeros_like(lbl)).unsqueeze(-1),
        inside.unsqueeze(-1).to(sm.dtype))
    return {"Logits@GRAD": [(sm - onehot) * dloss]}


# ------------------------------------------------------------ losses
@register_op("sigmoid_cross_entropy_with_logits", diff_inputs=["X"])
def _sigmoid_xent(ctx, ins, attrs):
    """max(x, 0) - x * label + log1p(exp(-|x|)); 0 where the label is
    ``ignore_index``; with ``normalize``, divided by the count of the
    other labels (at least 1)."""
    x, label = ins["X"][0], ins["Label"][0]
    loss = torch.clamp(x, min=0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        cnt = torch.clamp(torch.sum((label != ignore).to(x.dtype)), min=1.0)
        loss = loss / cnt
    return {"Out": [loss]}


@register_op("square_error_cost", diff_inputs=["X", "Y"])
def _square_error_cost(ctx, ins, attrs):
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": [d * d]}


@register_op("smooth_l1_loss", diff_inputs=["X"])
def _smooth_l1(ctx, ins, attrs):
    """Diff = (x - y) * InsideWeight; Out [N, 1] = the sum over each
    sample of OutsideWeight * (0.5 * sigma^2 * d^2 where |d| < 1 /
    sigma^2, else |d| - 0.5 / sigma^2). The weights are optional; the
    JAX package reads neither (no layer passes them), Fluid's
    smooth_l1_loss_op applies both."""
    x, y = ins["X"][0], ins["Y"][0]
    inside = (ins.get("InsideWeight") or [None])[0]
    outside = (ins.get("OutsideWeight") or [None])[0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    if inside is not None:
        d = d * inside
    ad = torch.abs(d)
    diff = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if outside is not None:
        diff = diff * outside
    return {"Diff": [d], "Out": [torch.sum(
        diff, dim=tuple(range(1, x.ndim))).reshape(-1, 1)]}


@register_op("huber_loss", diff_inputs=["X", "Y"])
def _huber_loss(ctx, ins, attrs):
    """Residual = y - x; Out = 0.5 r^2 where |r| <= delta, else delta *
    (|r| - 0.5 delta)."""
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    d = y - x
    ad = torch.abs(d)
    out = torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return {"Out": [out], "Residual": [d]}


@register_op("log_loss", diff_inputs=["Predicted"])
def _log_loss(ctx, ins, attrs):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + eps)
                     - (1 - label) * torch.log(1 - p + eps)]}


@register_op("maxout", diff_inputs=["X"])
def _maxout(ctx, ins, attrs):
    """The max over each run of ``groups`` channels (its grad shared
    among ties, as ``jnp.max``'s)."""
    x = ins["X"][0]
    groups = attrs["groups"]
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, c // groups, groups) + tuple(x.shape[2:]))
    return {"Out": [torch.amax(xg, dim=2)]}


@register_op("im2sequence", no_grad=True)
def _im2sequence(ctx, ins, attrs):
    raise NotImplementedError("im2sequence is not supported on the TPU "
                              "build, nor in the port")


# ------------------------------------------------------------------- top_k
@register_op("top_k", no_grad=True)
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis and their int32 indices, the
    lower index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True,
                           stable=True)
    k = attrs.get("k", 1)
    return {"Out": [vals[..., :k]],
            "Indices": [idx[..., :k].to(torch.int32)]}
