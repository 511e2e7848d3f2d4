"""NN ops: layer_norm, rms_norm, lookup_table, dropout, softmax,
softmax_with_cross_entropy, label_smooth.

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
"""

from __future__ import annotations

import torch

from ..core.registry import register_grad_lowering, register_op
from .basic import weak_scalar
from .tensor_ops import scatter_add_rows, take_rows


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
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - p)
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
