"""Sequence ops on padded dense batches.

The port of paddle_tpu/ops/sequence.py, all 14 ops. As there, a
sequence batch is ``X: [B, T, ...]`` padded plus ``Length: [B]``, and
each op is a masked dense op: positions ``t >= Length[b]`` are padding
and never reach a result or a gradient. Gradients come from the generic
``torch.func.vjp`` grad (core/autodiff.py), as the JAX package's come
from ``jax.vjp``.

Counterparts of the JAX calls: ``torch.gather`` with an index expanded
over the trailing dims stands in for ``jnp.take_along_axis`` (which
broadcasts), ``torch.isin`` for ``jnp.isin``, and ``sequence_erase``
compacts each row with a stable ``torch.argsort``, as ``jnp.argsort``
is stable.
"""

from __future__ import annotations

import torch

from ..core.lowering import as_torch_dtype
from ..core.registry import register_op


def _time_mask(x, length):
    """[B, T] bool mask, shaped to broadcast against ``x``, from a [B]
    length vector."""
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)
    m = t[None, :] < length.reshape(-1, 1)
    return m.reshape((B, T) + (1,) * (x.ndim - 2))


def _take_time(x, src):
    """``jnp.take_along_axis(x, src[..., None...], axis=1)``: the rows
    ``src[b, t]`` of each batch row's time axis."""
    idx = src.to(torch.int64).reshape(tuple(src.shape) + (1,) * (x.ndim - 2))
    idx = idx.expand(tuple(src.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("sequence_mask", no_grad=True)
def _sequence_mask(ctx, ins, attrs):
    x = ins["X"][0]  # lengths
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen")
    rng = torch.arange(maxlen, device=x.device)
    mask = rng[None, :] < x.reshape(-1, 1)
    mask = mask.reshape(tuple(x.shape) + (maxlen,))
    return {"Y": [mask.to(as_torch_dtype(attrs.get("out_dtype",
                                                   "float32")))]}


@register_op("sequence_pool", diff_inputs=["X"])
def _sequence_pool(ctx, ins, attrs):
    """Pool over the time axis under the mask. pool_type:
    average|sum|sqrt|max|last|first."""
    x = ins["X"][0]
    length = ins["Length"][0]
    ptype = attrs.get("pool_type", "average").lower()
    m = _time_mask(x, length)
    n = torch.clamp(length.reshape((-1,) + (1,) * (x.ndim - 2)), min=1)
    n = n.to(x.dtype)
    if ptype in ("average", "mean"):
        out = torch.sum(torch.where(m, x, _zero(x)), dim=1) / n
    elif ptype == "sum":
        out = torch.sum(torch.where(m, x, _zero(x)), dim=1)
    elif ptype == "sqrt":
        out = torch.sum(torch.where(m, x, _zero(x)), dim=1) / torch.sqrt(n)
    elif ptype == "max":
        neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                         device=x.device)
        out = torch.amax(torch.where(m, x, neg), dim=1)
    elif ptype == "last":
        idx = torch.clamp(length - 1, min=0).reshape(-1, 1)
        out = _take_time(x, idx).squeeze(1)
    elif ptype == "first":
        out = x[:, 0]
    else:
        raise ValueError("unknown pool_type %r" % ptype)
    return {"Out": [out]}


@register_op("sequence_softmax", diff_inputs=["X"])
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's valid time steps only."""
    x = ins["X"][0]
    length = ins["Length"][0]
    m = _time_mask(x, length)
    neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                     device=x.device)
    z = torch.where(m, x, neg)
    z = z - torch.logsumexp(z, dim=1, keepdim=True)
    return {"Out": [torch.where(m, torch.exp(z), _zero(x))]}


@register_op("sequence_reverse", diff_inputs=["X"])
def _sequence_reverse(ctx, ins, attrs):
    """Reverse each row's valid prefix; padding stays in place."""
    x = ins["X"][0]
    length = ins["Length"][0]
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = length.reshape(-1, 1).to(torch.int64)
    src = torch.where(t < L, L - 1 - t, t)
    return {"Y": [_take_time(x, src)]}


@register_op("sequence_expand", diff_inputs=["X"])
def _sequence_expand(ctx, ins, attrs):
    """Static form: each row of X repeated Y.shape[1] times."""
    x = ins["X"][0]
    rep = ins["Y"][0].shape[1]
    out = x.unsqueeze(1).expand((x.shape[0], rep) + tuple(x.shape[1:]))
    return {"Out": [out.reshape((x.shape[0] * rep,) + tuple(x.shape[1:]))]}


@register_op("sequence_expand_as", diff_inputs=["X"])
def _sequence_expand_as(ctx, ins, attrs):
    x = ins["X"][0]
    rep = ins["Y"][0].shape[0] // x.shape[0]
    return {"Out": [torch.repeat_interleave(x, rep, dim=0)]}


@register_op("sequence_conv", diff_inputs=["X", "Filter"])
def _sequence_conv(ctx, ins, attrs):
    """Context-window conv along time. Filter: [context_length * D, F];
    padding steps contribute zeros."""
    x = ins["X"][0]  # [B, T, D]
    filt = ins["Filter"][0]
    length = ins["Length"][0]
    ctx_len = int(attrs.get("context_length", 3))
    ctx_start = int(attrs.get("context_start", -(ctx_len // 2)))
    T = x.shape[1]
    m = _time_mask(x, length)
    xm = torch.where(m, x, _zero(x))
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(xm, -off, dims=1)
        valid = ((t + off) >= 0) & ((t + off) < T)
        cols.append(torch.where(valid[None, :, None], shifted, _zero(x)))
    col = torch.cat(cols, dim=-1)  # [B, T, ctx_len*D]
    out = torch.einsum("btc,cf->btf", col, filt)
    return {"Out": [torch.where(m, out, _zero(out))]}


@register_op("sequence_pad", diff_inputs=["X"])
def _sequence_pad(ctx, ins, attrs):
    """The input is already padded: the pad value goes back outside
    each row's valid prefix, and the lengths pass through."""
    x = ins["X"][0]
    length = ins["Length"][0]
    pad = ins["PadValue"][0] if ins.get("PadValue") else None
    pad = _zero(x) if pad is None else pad.to(x.dtype)
    out = torch.where(_time_mask(x, length), x, pad)
    return {"Out": [out], "Length": [length]}


@register_op("sequence_unpad", diff_inputs=["X"])
def _sequence_unpad(ctx, ins, attrs):
    """Zero the padding (the static shape stays)."""
    x = ins["X"][0]
    length = ins["Length"][0]
    return {"Out": [torch.where(_time_mask(x, length), x, _zero(x))]}


@register_op("sequence_concat", diff_inputs=["X"])
def _sequence_concat(ctx, ins, attrs):
    """Concatenate each row's valid prefixes along time: the output's
    time axis is the sum of the inputs', the padding packed to the
    tail."""
    xs = [v for v in ins["X"] if v is not None]
    lens = [v.to(torch.int32) for v in ins["Length"] if v is not None]
    B = xs[0].shape[0]
    T_out = sum(int(x.shape[1]) for x in xs)
    xcat = torch.cat(xs, dim=1)
    starts = []
    acc = 0
    for x in xs:
        starts.append(acc)
        acc += int(x.shape[1])
    total = sum(lens)
    dev = xcat.device
    t = torch.arange(T_out, dtype=torch.int32, device=dev)[None, :]
    src = torch.zeros((B, T_out), dtype=torch.int32, device=dev)
    cum = torch.zeros((B,), dtype=torch.int32, device=dev)
    for ln, st in zip(lens, starts):
        seg_pos = t - cum[:, None]
        in_seg = (seg_pos >= 0) & (seg_pos < ln[:, None])
        src = torch.where(in_seg, st + seg_pos, src)
        cum = cum + ln
    out = _take_time(xcat, src)
    m = t < total[:, None]
    out = torch.where(m.reshape(tuple(m.shape) + (1,) * (out.ndim - 2)),
                      out, _zero(out))
    return {"Out": [out], "LengthOut": [total]}


@register_op("sequence_slice", diff_inputs=["X"])
def _sequence_slice(ctx, ins, attrs):
    """Each row's [offset, offset + length) window, moved to the front
    of the time axis."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1)
    length = ins["SliceLength"][0].reshape(-1)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = torch.clamp(offset[:, None].to(torch.int64) + t, 0, T - 1)
    out = _take_time(x, src)
    m = t < length[:, None]
    out = torch.where(m.reshape(tuple(m.shape) + (1,) * (out.ndim - 2)),
                      out, _zero(out))
    return {"Out": [out], "LengthOut": [length]}


@register_op("sequence_enumerate", no_grad=True)
def _sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of ids, padded with pad_value past each row's
    length."""
    x = ins["X"][0]  # [B, T] ids
    length = ins["Length"][0] if ins.get("Length") else None
    win = int(attrs.get("win_size", 2))
    pad = torch.full((), int(attrs.get("pad_value", 0)), dtype=x.dtype,
                     device=x.device)
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)
    outs = []
    for k in range(win):
        shifted = torch.roll(x, -k, dims=1)
        valid = (t + k) < T
        if length is not None:
            valid = valid[None, :] & ((t[None, :] + k)
                                      < length.reshape(-1, 1))
        else:
            valid = valid[None, :].expand(B, T)
        outs.append(torch.where(valid, shifted, pad))
    return {"Out": [torch.stack(outs, dim=-1)]}


@register_op("sequence_erase", no_grad=True)
def _sequence_erase(ctx, ins, attrs):
    """Drop the listed tokens and compact each row's survivors to the
    front in order; the new lengths come out beside them."""
    x = ins["X"][0]  # [B, T] ids
    length = ins["Length"][0]
    tokens = torch.tensor(list(attrs.get("tokens", [])), dtype=x.dtype)
    # a host copy cannot be captured: on a CUDA graph's path the graph
    # keeps the tokens on the card (as ``assign_value`` does)
    tokens = (ctx.graph.constant(tokens, x.device) if ctx.graph is not None
              else tokens.to(x.device))
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    keep = _time_mask(x, length) & ~torch.isin(x, tokens)
    order = torch.argsort(torch.where(keep, t, T + 1), dim=1, stable=True)
    compacted = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1).to(length.dtype)
    out = torch.where(t < new_len[:, None], compacted, _zero(x))
    return {"Out": [out], "LengthOut": [new_len]}


@register_op("row_conv", diff_inputs=["X", "Filter"])
def _row_conv(ctx, ins, attrs):
    """Lookahead conv (streaming ASR): out[b, t] = sum_k filter[k] *
    x[b, t + k]."""
    x = ins["X"][0]  # [B, T, D]
    filt = ins["Filter"][0]  # [future_ctx, D]
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    out = torch.zeros_like(x)
    for k in range(filt.shape[0]):
        shifted = torch.roll(x, -k, dims=1)
        valid = (t + k) < T
        out = out + torch.where(valid[None, :, None], shifted,
                                _zero(x)) * filt[k][None, None, :]
    return {"Out": [out]}
