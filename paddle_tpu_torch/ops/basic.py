"""Basic tensor ops: constants (``fill_constant``,
``fill_constant_batch_size_like``, ``fill_any_like``), random init
(``uniform_random``, ``uniform_random_batch_size_like``,
``gaussian_random``, ``truncated_gaussian_random``), ``sampling_id``,
assign, assign_value, share_data, cast, scale, increment (the
learning-rate schedules' step counter), range, linspace, shape,
isfinite, ``one_hot``, and the clipping / sign ops that gradient
clipping and regularizers append.

Counterparts of paddle_tpu/ops/basic.py. Random ops draw from torch
generators (core/lowering.py LowerContext.next_rng), so their values
differ from the JAX package's; shape, dtype and range agree.
``truncated_gaussian_random`` draws by the inverse of the normal CDF
over [-2, 2] std; ``sampling_id`` takes the Gumbel-max of log(p +
1e-20), as ``jax.random.categorical`` does. A nonzero ``seed`` attr
fixes the draw (``uniform_random_batch_size_like`` has none, as in the
JAX package).

``linspace`` reads Start, Stop and Num on the host, as the JAX package
does: it carries ``host_sync``, so a plan that holds it is never
captured as a CUDA graph. ``shape`` makes its int32 vector from the
static shape, a graph constant under a capture (no host copy inside
it).

``weak_scalar`` gives a Python scalar the JAX package's weak typing
beside a bf16 (AMP) tensor: ``x * s`` is then the bf16 product of x and
bf16(s), as there, where torch would multiply by the f32 value of s.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.lowering import as_torch_dtype
from ..core.registry import register_op


@functools.lru_cache(maxsize=256)
def _rounded(v: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(v, dtype=dtype))


def weak_scalar(v, like: torch.Tensor):
    """The Python scalar ``v`` as it enters an expression with ``like``
    in the JAX package, where a Python scalar is weakly typed: rounded to
    ``like``'s dtype first where that is narrower than f32 (bf16 under
    AMP), unchanged otherwise."""
    if like.dtype in (torch.bfloat16, torch.float16):
        return _rounded(float(v), like.dtype)
    return v


def _dt(attrs, default="float32"):
    return as_torch_dtype(attrs.get("dtype", default) or default)


def _rng(ctx, attrs):
    """A random op's generator: fixed by a nonzero ``seed`` attr, else
    the chain's next."""
    seed = attrs.get("seed", 0)
    return ctx.seeded_rng(int(seed)) if seed else ctx.next_rng()


@register_op("fill_constant", no_grad=True)
def _fill_constant(ctx, ins, attrs):
    shape = tuple(attrs.get("shape", []))
    val = attrs.get("value", 0.0)
    return {"Out": [torch.full(shape, val, dtype=_dt(attrs),
                               device=ctx.device)]}


@register_op("fill_constant_batch_size_like", no_grad=True)
def _fill_constant_bsl(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=_dt(attrs), device=ctx.device)]}


@register_op("one_hot", no_grad=True)
def _one_hot(ctx, ins, attrs):
    """f32 rows of ``depth``; an id outside [0, depth) gives an all-zero
    row, as ``jax.nn.one_hot`` does (``F.one_hot`` would raise, and wants
    int64 ids where the card holds int32). A trailing 1 of the ids is
    squeezed."""
    x = ins["X"][0]
    depth = attrs["depth"]
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    classes = torch.arange(depth, dtype=x.dtype, device=x.device)
    return {"Out": [(x.unsqueeze(-1) == classes).to(torch.float32)]}


@register_op("uniform_random", no_grad=True, uses_rng=True)
def _uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(tuple(attrs["shape"]), generator=_rng(ctx, attrs),
                     dtype=_dt(attrs), device=ctx.device)
    return {"Out": [out * (hi - lo) + lo]}


@register_op("gaussian_random", no_grad=True, uses_rng=True)
def _gaussian_random(ctx, ins, attrs):
    """``mean + std * N(0, 1)`` of ``shape``; a nonzero ``seed`` attr
    fixes the draw, as for ``uniform_random``."""
    z = torch.randn(tuple(attrs["shape"]), generator=_rng(ctx, attrs),
                    dtype=_dt(attrs), device=ctx.device)
    return {"Out": [attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z]}


@register_op("assign")
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("assign_value", no_grad=True)
def _assign_value(ctx, ins, attrs):
    # the constant-folding pass (core/passes/fold.py) bakes its results
    # into these
    if ctx.graph is not None:
        # on a CUDA graph's path: a constant the graph keeps on the card
        # (a host copy cannot be captured)
        out = ctx.graph.constant(
            torch.tensor(attrs["values"], dtype=_dt(attrs)), ctx.device)
    else:
        # made on the device: an exported program (export/artifact.py)
        # then holds it there, with no host copy in its graph
        out = torch.tensor(attrs["values"], dtype=_dt(attrs),
                           device=ctx.device)
    return {"Out": [out.reshape(tuple(attrs["shape"]))]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(as_torch_dtype(attrs["out_dtype"]))]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    s = weak_scalar(attrs.get("scale", 1.0), x)
    b = weak_scalar(attrs.get("bias", 0.0), x)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register_op("increment", no_grad=True)
def _increment(ctx, ins, attrs):
    return {"Out": [ins["X"][0] + attrs.get("step", 1.0)]}


@register_op("range", no_grad=True)
def _range(ctx, ins, attrs):
    # the layer records static bounds in attrs; the tensor inputs are kept
    # only for desc-level parity with range_op.cc
    if "static_start" in attrs:
        bounds = [attrs[k] for k in ("static_start", "static_end",
                                     "static_step")]
        # integer bounds count exactly, as the reference's int32
        # jnp.arange of Python ints; float bounds in float32, as its
        # float32 jnp.arange
        exact = all(isinstance(b, (int, np.integer)) for b in bounds)
        out = torch.arange(*bounds, device=ctx.device,
                           dtype=torch.int64 if exact else torch.float32)
        return {"Out": [out.to(_dt(attrs))]}
    # the reference takes the tensor bounds through Python floats into a
    # float32 jnp.arange (x64 off), whatever their dtype; so does the port
    start, end, step = ins["Start"][0], ins["End"][0], ins["Step"][0]
    s, e, st = (float(v.reshape(())) for v in (start, end, step))
    out = torch.arange(s, e, st, dtype=torch.float32, device=ctx.device)
    return {"Out": [out.to(start.dtype)]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs.get("min"),
                                attrs.get("max"))]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": [x * scale.to(x.dtype)]}


@register_op("sign", no_grad=True)
def _sign(ctx, ins, attrs):
    return {"Out": [torch.sign(ins["X"][0])]}


@register_op("fill_any_like", no_grad=True)
def _fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    dt = as_torch_dtype(dtype) if dtype else x.dtype
    return {"Out": [torch.full(tuple(x.shape), attrs.get("value", 0.0),
                               dtype=dt, device=x.device)]}


@register_op("truncated_gaussian_random", no_grad=True, uses_rng=True)
def _trunc_gaussian(ctx, ins, attrs):
    """``mean + std * z`` with z normal truncated to [-2, 2], drawn by
    the inverse CDF of a uniform over [Phi(-2), Phi(2)]."""
    dt = _dt(attrs)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(tuple(attrs["shape"]), generator=_rng(ctx, attrs),
                   dtype=torch.float32, device=ctx.device)
    u = lo + u * (1.0 - 2.0 * lo)  # Phi(2) = 1 - Phi(-2)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
    return {"Out": [(attrs.get("mean", 0.0)
                     + attrs.get("std", 1.0) * z).to(dt)]}


@register_op("uniform_random_batch_size_like", no_grad=True, uses_rng=True)
def _uniform_random_bsl(ctx, ins, attrs):
    """U[min, max) of ``shape`` with its ``output_dim_idx`` axis taken
    from Input's ``input_dim_idx`` axis; from the chain (the JAX package
    reads no seed attr here)."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(tuple(shape), generator=ctx.next_rng(),
                     dtype=_dt(attrs), device=ctx.device)
    return {"Out": [out * (hi - lo) + lo]}


@register_op("share_data")
def _share_data(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("shape", no_grad=True)
def _shape(ctx, ins, attrs):
    host = torch.tensor(tuple(ins["Input"][0].shape), dtype=torch.int32)
    if ctx.graph is not None:
        # a host copy cannot be captured: a constant the graph keeps
        return {"Out": [ctx.graph.constant(host, ctx.device)]}
    return {"Out": [host.to(ctx.device)]}


@register_op("isfinite", no_grad=True)
def _isfinite(ctx, ins, attrs):
    """[1] bool: every element finite."""
    return {"Out": [torch.isfinite(ins["X"][0]).all().reshape(1)]}


@register_op("linspace", no_grad=True, host_sync=True)
def _linspace(ctx, ins, attrs):
    """Num f32 points from Start to Stop, both ends included; the three
    [1] inputs are read on the host."""
    start, stop, num = (ins[k][0].reshape(()).item()
                        for k in ("Start", "Stop", "Num"))
    return {"Out": [torch.linspace(float(start), float(stop), int(num),
                                   dtype=torch.float32, device=ctx.device)]}


@register_op("sampling_id", no_grad=True, uses_rng=True)
def _sampling_id(ctx, ins, attrs):
    """One id per row of the [N, C] probabilities X, drawn as
    ``jax.random.categorical(log(X + 1e-20))``: the argmax of the logits
    plus Gumbel noise."""
    x = ins["X"][0]
    u = torch.rand(tuple(x.shape), generator=_rng(ctx, attrs),
                   dtype=torch.float32, device=x.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    logits = torch.log(x.to(torch.float32) + 1e-20)
    return {"Out": [torch.argmax(logits + gumbel, dim=-1).to(torch.int32)]}
