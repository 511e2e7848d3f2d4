"""Tensor-manipulation ops: reshape / transpose (and their *2 variants),
squeeze / unsqueeze / flatten (and their *2 variants), split, unstack,
expand, expand_as, tile, concat, stack, slice, strided_slice, gather,
gather_nd, scatter, pad, pad2d, crop, reverse, roll, meshgrid,
shard_index, where_op (its grad is the generic vjp), and the decoder's
``rope`` and ``kv_cache_write``.

Counterparts of paddle_tpu/ops/tensor_ops.py. The *2 variants also emit
an empty XShape output for the grad path, matching the reference's op
pairs.

An index past the rows (``gather`` here, ``lookup_table`` in ops/nn.py)
takes the JAX package's ``jnp.take`` fill mode: its row is NaN (the
dtype's fill value), a negative index in [-n, 0) wraps, and the grad
drops what it does not reach. The index is clamped and the row masked on
the device (``take_rows``): no host sync inside a captured step, and no
device assert.

Plain indexing (``gather_nd``'s ``x[idx]``) clamps as JAX's indexing
does: a negative index wraps once, then any index is clamped into
[0, n) (``clamped_index``).

``scatter`` writes on the device in an order that does not depend on
it: with ``overwrite`` the last occurrence of a repeated id wins, as the
reference's CPU ``scatter_op`` loop has it (JAX's ``.at[].set`` leaves
the winner unspecified, and ``index_put_`` on CUDA picks any), and
without it the rows add in a fixed order (``add_rows``, as for
``gather``'s grad). An id outside [-n, n) is dropped.

``gather`` has a grad lowering of its own: the vjp of ``index_select``
scatters with ``index_add_``, which on CUDA adds repeated indices with
atomics in an order that changes from run to run. The grad lowering
adds them with ``add_rows``: on CUDA ``index_put_(accumulate=True)``,
which sorts the indices and sums each one's rows in a fixed order, on
the CPU ``index_add_`` (the CPU's ``index_put_`` adds a large input in
parallel), so a training step is bitwise repeatable. Its forward
gathers by advanced indexing, whose autograd backward (what a recompute
segment's vjp takes) is that same ``index_put_``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


@register_op("unsqueeze", diff_inputs=["X"])
def _unsqueeze(ctx, ins, attrs):
    out = ins["X"][0]
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out]}


@register_op("unsqueeze2", diff_inputs=["X"])
def _unsqueeze2(ctx, ins, attrs):
    return {"Out": _unsqueeze(ctx, ins, attrs)["Out"],
            "XShape": [_xshape(ins["X"][0])]}


@register_op("squeeze", diff_inputs=["X"])
def _squeeze(ctx, ins, attrs):
    """Drop the listed axes of size 1 (every size-1 axis when none are
    listed); a listed axis of another size stays, as in the JAX
    package."""
    x = ins["X"][0]
    axes = [a % x.ndim for a in attrs.get("axes", [])] or \
        [i for i, s in enumerate(x.shape) if s == 1]
    keep = [s for i, s in enumerate(x.shape)
            if not (i in axes and s == 1)]
    return {"Out": [x.reshape(keep)]}


@register_op("squeeze2", diff_inputs=["X"])
def _squeeze2(ctx, ins, attrs):
    return {"Out": _squeeze(ctx, ins, attrs)["Out"],
            "XShape": [_xshape(ins["X"][0])]}


@register_op("flatten", diff_inputs=["X"])
def _flatten(ctx, ins, attrs):
    """[prod(shape[:axis]), prod(shape[axis:])]."""
    x = ins["X"][0]
    lead = 1
    for s in x.shape[:attrs.get("axis", 1)]:
        lead *= s
    return {"Out": [x.reshape(lead, -1)]}


@register_op("flatten2", diff_inputs=["X"])
def _flatten2(ctx, ins, attrs):
    return {"Out": _flatten(ctx, ins, attrs)["Out"],
            "XShape": [_xshape(ins["X"][0])]}


@register_op("split", diff_inputs=["X"])
def _split(ctx, ins, attrs):
    """``num`` equal parts, or parts cut after each of ``sections`` but
    the last (the last part takes the rest), as ``jnp.split``."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError("split: axis %d of size %d does not divide "
                             "into %d equal parts" % (axis, x.shape[axis],
                                                      num))
        return {"Out": list(torch.chunk(x, num, dim=axis))}
    cuts, acc = [], 0
    for s in attrs.get("sections", [])[:-1]:
        acc += s
        cuts.append(acc)
    return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}


@register_op("unstack", diff_inputs=["X"])
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


def _tile(x, reps):
    """``jnp.tile(x, reps)``: ``reps`` shorter than x's rank is padded
    with leading 1s, a longer one adds leading axes."""
    reps = tuple(int(r) for r in reps)
    return x.repeat((1,) * (x.ndim - len(reps)) + reps)


@register_op("expand", diff_inputs=["X"])
def _expand(ctx, ins, attrs):
    """``expand_times`` copies along each axis (``jnp.tile``)."""
    return {"Out": [_tile(ins["X"][0], attrs["expand_times"])]}


@register_op("expand_as", diff_inputs=["X"])
def _expand_as(ctx, ins, attrs):
    x, target = ins["X"][0], ins["target_tensor"][0]
    return {"Out": [_tile(x, [t // s for t, s in zip(target.shape,
                                                      x.shape)])]}


@register_op("tile", diff_inputs=["X"])
def _tile_op(ctx, ins, attrs):
    return {"Out": [_tile(ins["X"][0], attrs["repeat_times"])]}


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


def add_rows(base, idx, rows):
    """``base`` with ``rows`` added at the int64 ``idx`` along axis 0,
    the rows of a repeated index added in their order, the same bits at
    every run: ``index_put_(accumulate=True)`` on CUDA (it sorts the
    indices stably, then adds each one's rows in turn), ``index_add_``
    on the CPU (whose ``index_put_`` adds a large input's rows in
    parallel, in an order that changes from run to run)."""
    if base.is_cuda:
        return base.index_put((idx,), rows, accumulate=True)
    return base.index_add(0, idx, rows)


def scatter_add_rows(shape, idx, rows, axis=0):
    """zeros(shape) with ``rows`` added at ``idx`` along ``axis``:
    repeated indices summed in a fixed order (deterministic on CUDA). An
    index outside [-n, n) is dropped (JAX's scatter); a negative one
    wraps."""
    n = shape[axis]
    safe, valid = bounded_index(idx, n)
    wide = list(shape)
    wide[axis] = n + 1  # row n takes the dropped indices' rows
    out = add_rows(torch.zeros(wide, dtype=rows.dtype,
                               device=rows.device).movedim(axis, 0),
                   torch.where(valid, safe, n), rows.movedim(axis, 0))
    return out.movedim(0, axis).narrow(axis, 0, n).contiguous()


@register_grad_lowering("gather")
def _gather_grad(ctx, ins, attrs):
    x, idx = ins["X"][0], _gather_index(ins["Index"][0])
    g = ins["Out@GRAD"][0]
    return {"X@GRAD": [scatter_add_rows(x.shape, idx, g.to(x.dtype),
                                        attrs.get("axis", 0))]}


def clamped_index(idx, n):
    """``idx`` as JAX's plain indexing takes it: a negative index wraps
    once, then every index is clamped into [0, n); int64, on the
    device."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@register_op("gather_nd", diff_inputs=["X"])
def _gather_nd(ctx, ins, attrs):
    """``x[tuple(index[..., k])]``: the last axis of Index addresses x's
    leading axes."""
    x, idx = ins["X"][0], ins["Index"][0]
    parts = tuple(clamped_index(idx[..., k], x.shape[k])
                  for k in range(idx.shape[-1]))
    return {"Out": [x[parts]]}


def _last_occurrence(ids):
    """[N] bool: True where no later entry of ``ids`` repeats the id (a
    stable sort keeps each id's entries in order; the last of a run is
    the last occurrence)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    last = torch.ones_like(sorted_ids, dtype=torch.bool)
    last[:-1] = sorted_ids[:-1] != sorted_ids[1:]
    out = torch.empty_like(last)
    out[order] = last
    return out


@register_op("scatter", diff_inputs=["X", "Updates"])
def _scatter(ctx, ins, attrs):
    """Out = X with the rows at Ids set to (``overwrite``, the last of
    repeated ids winning) or added by (in a fixed order) the rows of
    Updates; an id outside [-n, n) is dropped, a negative one wraps."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    if ids.ndim == 2 and ids.shape[1] == 1:
        ids = ids[:, 0]
    n = x.shape[0]
    overwrite = attrs.get("overwrite", True)
    safe, valid = bounded_index(ids, n)
    rows = torch.where(valid, safe, n)  # row n takes the dropped ids'
    if overwrite:
        rows = torch.where(_last_occurrence(rows), rows, n)
    out = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if overwrite:
        out = out.index_put((rows,), upd.to(x.dtype))
    else:
        out = add_rows(out, rows, upd.to(x.dtype))
    return {"Out": [out[:n]]}


@register_op("pad", diff_inputs=["X"])
def _pad(ctx, ins, attrs):
    """``paddings`` holds (before, after) for each axis, first axis
    first; ``pad_value`` fills."""
    x = ins["X"][0]
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.ndim)):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": [F.pad(x, flat, value=attrs.get("pad_value", 0.0))]}


@register_op("pad2d", diff_inputs=["X"])
def _pad2d(ctx, ins, attrs):
    """NCHW; ``paddings`` is [top, bottom, left, right]; mode constant
    (``pad_value``), reflect (the edge not repeated) or edge (the edge
    repeated)."""
    x = ins["X"][0]
    p = attrs["paddings"]
    flat = [p[2], p[3], p[0], p[1]]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [F.pad(x, flat, value=attrs.get("pad_value", 0.0))]}
    return {"Out": [F.pad(x, flat, mode={"reflect": "reflect",
                                         "edge": "replicate"}[mode])]}


@register_op("crop", diff_inputs=["X"])
def _crop(ctx, ins, attrs):
    x = ins["X"][0]
    idx = tuple(slice(o, o + s) for o, s in zip(attrs["offsets"],
                                                 attrs["shape"]))
    return {"Out": [x[idx]]}


@register_op("reverse", diff_inputs=["X"])
def _reverse(ctx, ins, attrs):
    return {"Out": [torch.flip(ins["X"][0], list(attrs["axis"]))]}


@register_op("roll", diff_inputs=["X"])
def _roll(ctx, ins, attrs):
    """``jnp.roll``: no axis rolls the flattened tensor."""
    axis = attrs.get("axis")
    x = ins["X"][0]
    if axis is None or (isinstance(axis, (list, tuple)) and not axis):
        return {"Out": [torch.roll(x, attrs["shifts"])]}
    return {"Out": [torch.roll(x, attrs["shifts"], axis)]}


@register_op("meshgrid", diff_inputs=["X"])
def _meshgrid(ctx, ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register_op("shard_index", no_grad=True)
def _shard_index(ctx, ins, attrs):
    """An id in this shard becomes its offset in the shard, any other
    ``ignore_value`` (floor division and modulo, as ``//`` and ``%``)."""
    x = ins["X"][0]
    nshards = attrs["nshards"]
    size = (attrs["index_num"] + nshards - 1) // nshards
    in_shard = (x // size) == attrs["shard_id"]
    return {"Out": [torch.where(in_shard, x % size,
                                attrs.get("ignore_value", -1))]}


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


@register_op("strided_slice", diff_inputs=["Input"])
def _strided_slice(ctx, ins, attrs):
    """Python's ``x[s:e:st]`` on each listed axis; a negative stride
    walks back from ``s`` (taken from the flipped axis)."""
    x = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        n = x.shape[a]
        start, stop, step = slice(s, e, st).indices(n)
        if step > 0:
            x = x[(slice(None),) * (a % x.ndim) + (slice(start, stop,
                                                         step),)]
        else:
            # x[start:stop:step] is flip(x)[n-1-start : n-1-stop : -step]
            x = torch.flip(x, [a])[(slice(None),) * (a % x.ndim) + (
                slice(n - 1 - start, n - 1 - stop, -step),)]
    return {"Out": [x]}


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
