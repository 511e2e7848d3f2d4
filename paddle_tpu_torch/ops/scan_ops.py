"""scan_layers: N identical layers over stacked [n_layers, ...] params.

The port of paddle_tpu/ops/scan_ops.py, the lowering of the op that
layers/scan_ext.py builds. Where the JAX package runs ``lax.scan`` over
the stacked parameter slices, the port runs a loop over them, carrying
the activation; captured outer tensors (attention bias, positions, ...)
reach every iteration unchanged.

- **Randomness.** The JAX package draws one base key and folds in the
  layer index. The port records the random streams each layer draws
  (``LowerContext.streams``, as ops/recompute_ops.py does) and exports
  them, layer by layer, through ``RngKey`` (a ``SegmentStreams`` whose
  tokens are one tuple per layer); the grad replays them
  (``LowerContext.replay``), so its dropout masks are the forward's.
- **Grad.** The forward runs without autograd and keeps only each
  layer's input. The grad re-runs the forward of one layer at a time,
  in reverse order, under autograd over detached inputs, and applies
  the cotangent with ``torch.autograd.grad``: each layer's activations
  live only for its own backward. That is the profile the JAX package
  gets with ``remat=True`` (``jax.checkpoint`` around the body), so
  ``remat`` changes neither values nor memory here.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..core.lowering import LowerContext, lower_ops
from ..core.registry import register_grad_lowering, register_op
from .recompute_ops import SegmentStreams

__all__: List[str] = []


def _layer(ctx, sub, attrs, x, slices, captured, streams=None,
           replay=None):
    """One layer: the sub-block on (x, this layer's slices, the captured
    tensors)."""
    env: Dict[str, Any] = dict(zip(attrs["slice_names"], slices))
    env.update(zip(attrs["captured_names"], captured))
    env[attrs["in_name"]] = x
    sctx = LowerContext(sub, ctx._rng, ctx.device, ctx.is_test, ctx.amp,
                        ctx.graph, **ctx.mesh_kw())
    sctx.streams, sctx.replay = streams, replay
    lower_ops(sctx, sub.ops, env)
    return env[attrs["out_name"]]


def _draws(ctx, attrs) -> bool:
    return bool(attrs.get("uses_rng")) and not (
        ctx.is_test or attrs.get("is_test", False) or ctx._rng is None)


@register_op("scan_layers", diff_inputs=["X", "StackedParams", "Captured"],
             needs_env=False, uses_rng=True)
def _scan_layers(ctx, ins, attrs):
    sub = ctx.block.program.block(attrs["sub_block"])
    x = ins["X"][0]
    stacked = list(ins["StackedParams"])
    captured = list(ins.get("Captured") or [])
    draws = _draws(ctx, attrs)
    per_layer = []
    for i in range(int(attrs["n_layers"])):
        streams = [] if draws else None
        x = _layer(ctx, sub, attrs, x, [p[i] for p in stacked], captured,
                   streams)
        per_layer.append(tuple(streams or ()))
    res = {"Out": [x]}
    if attrs.get("uses_rng"):
        res["RngKey"] = [SegmentStreams(per_layer)]
    return res


@register_grad_lowering("scan_layers")
def _scan_layers_grad(ctx, ins, attrs):
    """The per-layer backward, last layer first; each layer's input
    comes from a forward re-run with the recorded streams replayed."""
    sub = ctx.block.program.block(attrs["sub_block"])
    n = int(attrs["n_layers"])
    x = ins["X"][0]
    stacked = list(ins["StackedParams"])
    captured = list(ins.get("Captured") or [])
    per_layer = [()] * n
    if attrs.get("uses_rng") and ins.get("RngKey"):
        per_layer = list(ins["RngKey"][0].tokens) or per_layer

    def replay(i):
        return list(per_layer[i]) if per_layer[i] else None

    # each layer's input, from the forward again (no autograd)
    xs = [x]
    for i in range(n - 1):
        xs.append(_layer(ctx, sub, attrs, xs[-1], [p[i] for p in stacked],
                         captured, replay=replay(i)))

    # only float captured tensors carry cotangents (positions, segment
    # ids are ints)
    fidx = [j for j, v in enumerate(captured)
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    g = (ins.get("Out@GRAD") or [None])[0]
    dstack: List[List[torch.Tensor]] = [[None] * n for _ in stacked]
    dcap: List[Any] = [None] * len(captured)
    for i in reversed(range(n)):
        xi = xs[i].detach().requires_grad_()
        slices = [p[i].detach().requires_grad_() for p in stacked]
        caps = list(captured)
        for j in fidx:
            caps[j] = captured[j].detach().requires_grad_()
        with torch.enable_grad():
            out = _layer(ctx, sub, attrs, xi, slices, caps,
                         replay=replay(i))
        if g is None:
            g = torch.zeros_like(out)
        elif g.dtype != out.dtype or g.shape != out.shape:
            g = torch.broadcast_to(g.to(out.dtype), out.shape)
        leaves = [xi] + slices + [caps[j] for j in fidx]
        grads = (torch.autograd.grad([out], leaves, [g], allow_unused=True)
                 if out.requires_grad else [None] * len(leaves))
        grads = [torch.zeros_like(v) if d is None else d
                 for v, d in zip(leaves, grads)]
        g = grads[0]
        for k in range(len(stacked)):
            dstack[k][i] = grads[1 + k]
        for j, d in zip(fidx, grads[1 + len(stacked):]):
            dcap[j] = d if dcap[j] is None else dcap[j] + d
    return {"X@GRAD": [g],
            "StackedParams@GRAD": [torch.stack(ds) for ds in dstack],
            "Captured@GRAD": dcap}
