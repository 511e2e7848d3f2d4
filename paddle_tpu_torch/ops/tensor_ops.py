"""Tensor-manipulation ops: reshape / transpose (and their *2 variants),
unsqueeze2, gather, where_op (its grad is the generic vjp).

Counterparts of paddle_tpu/ops/tensor_ops.py. The *2 variants also emit
an empty XShape output for the grad path, matching the reference's op
pairs.

``gather`` has a grad lowering of its own: the vjp of ``index_select``
scatters with ``index_add_``, which on CUDA adds repeated indices with
atomics in an order that changes from run to run. The grad lowering
adds them with ``index_put_(accumulate=True)``, which sorts the indices
and sums each one's rows in a fixed order, so a training step is
bitwise repeatable. Its forward gathers by advanced indexing, whose
autograd backward (what a recompute segment's vjp takes) is that same
``index_put_``.
"""

from __future__ import annotations

import torch

from ..core.registry import register_grad_lowering, register_op


def _infer_reshape(x, shape):
    shape = list(shape)
    out = []
    neg = -1
    known = 1
    for i, s in enumerate(shape):
        if s == -1:
            neg = i
            out.append(-1)
        elif s == 0:
            out.append(x.shape[i])
            known *= x.shape[i]
        else:
            out.append(int(s))
            known *= int(s)
    if neg >= 0:
        out[neg] = int(x.numel() // known)
    return tuple(out)


def _xshape(x):
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape", diff_inputs=["X"])
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(_infer_reshape(x, attrs["shape"]))]}


@register_op("reshape2", diff_inputs=["X"])
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x.reshape(_infer_reshape(x, attrs["shape"]))
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("transpose", diff_inputs=["X"])
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register_op("transpose2", diff_inputs=["X"])
def _transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register_op("unsqueeze2", diff_inputs=["X"])
def _unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [_xshape(x)]}


def _gather_index(idx):
    if idx.ndim == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    return idx.to(torch.int64)


@register_op("gather", diff_inputs=["X"])
def _gather(ctx, ins, attrs):
    x, idx = ins["X"][0], _gather_index(ins["Index"][0])
    axis = attrs.get("axis", 0)
    return {"Out": [x.movedim(axis, 0)[idx].movedim(0, axis)]}


def scatter_add_rows(shape, idx, rows, axis=0):
    """zeros(shape) with ``rows`` added at ``idx`` along ``axis``:
    repeated indices summed in a fixed order (deterministic on CUDA)."""
    out = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
    out.movedim(axis, 0).index_put_((idx,), rows.movedim(axis, 0),
                                    accumulate=True)
    return out


@register_grad_lowering("gather")
def _gather_grad(ctx, ins, attrs):
    x, idx = ins["X"][0], _gather_index(ins["Index"][0])
    g = ins["Out@GRAD"][0]
    return {"X@GRAD": [scatter_add_rows(x.shape, idx, g.to(x.dtype),
                                        attrs.get("axis", 0))]}


@register_op("where_op", diff_inputs=["X", "Y"])
def _where(ctx, ins, attrs):
    cond, x, y = ins["Condition"][0], ins["X"][0], ins["Y"][0]
    return {"Out": [torch.where(cond, x, y)]}
