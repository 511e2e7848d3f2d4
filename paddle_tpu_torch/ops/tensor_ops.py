"""Tensor-manipulation ops: reshape / transpose (and their *2 variants),
unsqueeze2, squeeze2, expand, concat, stack, slice, gather, where_op
(its grad is the generic vjp), and the decoder's ``rope`` and
``kv_cache_write``.

Counterparts of paddle_tpu/ops/tensor_ops.py. The *2 variants also emit
an empty XShape output for the grad path, matching the reference's op
pairs.

An index past the rows (``gather`` here, ``lookup_table`` in ops/nn.py)
takes the JAX package's ``jnp.take`` fill mode: its row is NaN (the
dtype's fill value), a negative index in [-n, 0) wraps, and the grad
drops what it does not reach. The index is clamped and the row masked on
the device (``take_rows``): no host sync inside a captured step, and no
device assert.

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


@register_op("squeeze2", diff_inputs=["X"])
def _squeeze2(ctx, ins, attrs):
    """Drop the listed axes of size 1 (every size-1 axis when none are
    listed); a listed axis of another size stays, as in the JAX
    package."""
    x = ins["X"][0]
    axes = [a % x.ndim for a in attrs.get("axes", [])] or \
        [i for i, s in enumerate(x.shape) if s == 1]
    keep = [s for i, s in enumerate(x.shape)
            if not (i in axes and s == 1)]
    return {"Out": [x.reshape(keep)], "XShape": [_xshape(x)]}


@register_op("expand", diff_inputs=["X"])
def _expand(ctx, ins, attrs):
    """``expand_times`` copies along each axis (``jnp.tile``)."""
    return {"Out": [ins["X"][0].repeat(*attrs["expand_times"])]}


def _gather_index(idx):
    if idx.ndim == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    return idx.to(torch.int64)


def bounded_index(idx, n):
    """(``idx`` wrapped and clamped into [0, n), where ``idx`` lies in
    [-n, n)): computed on the device, as int64."""
    idx = idx.to(torch.int64)
    valid = (idx >= -n) & (idx < n)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1), valid


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def take_rows(x, idx, axis=0):
    """``jnp.take(x, idx, axis)`` in fill mode: the rows of ``x`` along
    ``axis`` at ``idx`` (its dims in place of ``axis``), an index in
    [-n, 0) wrapping, one outside [-n, n) giving a row of the fill value
    (NaN for floats)."""
    safe, valid = bounded_index(idx, x.shape[axis])
    out = x.movedim(axis, 0)[safe]
    valid = valid.reshape(tuple(valid.shape) + (1,) * (x.ndim - 1))
    out = torch.where(valid, out, _fill_value(x.dtype))
    k = idx.ndim
    return out.movedim(tuple(range(k)), tuple(range(axis, axis + k)))


@register_op("gather", diff_inputs=["X"])
def _gather(ctx, ins, attrs):
    x, idx = ins["X"][0], _gather_index(ins["Index"][0])
    return {"Out": [take_rows(x, idx, attrs.get("axis", 0))]}


def scatter_add_rows(shape, idx, rows, axis=0):
    """zeros(shape) with ``rows`` added at ``idx`` along ``axis``:
    repeated indices summed in a fixed order (deterministic on CUDA). An
    index outside [-n, n) is dropped (JAX's scatter); a negative one
    wraps."""
    n = shape[axis]
    safe, valid = bounded_index(idx, n)
    wide = list(shape)
    wide[axis] = n + 1  # row n takes the dropped indices' rows
    out = torch.zeros(wide, dtype=rows.dtype, device=rows.device)
    out.movedim(axis, 0).index_put_((torch.where(valid, safe, n),),
                                    rows.movedim(axis, 0), accumulate=True)
    return out.narrow(axis, 0, n).contiguous()


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


@register_op("concat", diff_inputs=["X"])
def _concat(ctx, ins, attrs):
    xs = [x for x in ins["X"] if x is not None]
    return {"Out": [torch.cat(xs, dim=attrs.get("axis", 0))]}


@register_op("stack", diff_inputs=["X"])
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("slice", diff_inputs=["Input"])
def _slice(ctx, ins, attrs):
    """Starts and ends clamped as the JAX package clamps them: a negative
    one counts from the end (at least 0), a positive one past the end
    stops there."""
    x = ins["Input"][0]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": [x[tuple(idx)]]}


@register_op("kv_cache_write", no_grad=True)
def _kv_cache_write(ctx, ins, attrs):
    """A decode step's K or V rows [B, H, U, D] written into the
    persistable [B, H, S, D] cache at a runtime position, IN PLACE: the
    op's Out is its Cache var, so the scope's tensor is the one updated
    (the JAX package donates it), and a captured step writes it with no
    copy of the whole cache. Pos is a [1] scalar (every row writes at it:
    ``index_copy_`` along S) or [B] / [B, 1] per-row positions (a
    scatter of each row's slab). The start is taken as
    ``lax.dynamic_update_slice`` takes it, on the device: a negative one
    counts from the end once, then it is clamped to [0, S - U]; nothing
    reads the position on the host."""
    cache, upd, pos = ins["Cache"][0], ins["Update"][0], ins["Pos"][0]
    seq, u = cache.shape[2], upd.shape[2]
    upd = upd.to(cache.dtype)
    steps = torch.arange(u, device=cache.device)
    start = pos.reshape(-1).to(torch.int64)
    start = torch.where(start < 0, start + seq, start).clamp(0, seq - u)
    if pos.numel() > 1:
        rows = start[:, None] + steps                       # [B, U]
        batch = torch.arange(rows.shape[0], device=cache.device)
        cache.permute(0, 2, 1, 3).index_put_(
            (batch[:, None].expand_as(rows), rows), upd.permute(0, 2, 1, 3))
    else:
        cache.index_copy_(2, start + steps, upd)
    return {"Out": [cache]}


@register_op("rope", diff_inputs=["X"])
def _rope(ctx, ins, attrs):
    """Rotary position embedding (rotate-half) on [..., S, D] head
    tensors: pairs (x_i, x_{i+D/2}) rotate by pos * base^(-2i/D). Angles,
    sin and cos in f32, cast to x's dtype before the products, as in the
    JAX package. Positions: [S], [1] (a decode step) or [B, S] (packed
    rows, with a [B, H, S, D] x only). The grad is the generic vjp."""
    x, pos = ins["X"][0], ins["Pos"][0]
    base = float(attrs.get("base", 10000.0))
    half = x.shape[-1] // 2
    inv = base ** (-torch.arange(0, half, dtype=torch.float32,
                                 device=x.device) / half)
    if pos.ndim == 2:
        if x.ndim != 4:
            raise ValueError(
                "rope with [B, S] positions needs a [B, H, S, D] "
                "head tensor; got x rank %d" % x.ndim)
        ang = pos.to(torch.float32)[..., None] * inv
        sin = torch.sin(ang).to(x.dtype)[:, None]
        cos = torch.cos(ang).to(x.dtype)[:, None]
    else:
        ang = pos.reshape(-1).to(torch.float32)[:, None] * inv[None, :]
        sin = torch.sin(ang).to(x.dtype)
        cos = torch.cos(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return {"Out": [torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                              dim=-1)]}
