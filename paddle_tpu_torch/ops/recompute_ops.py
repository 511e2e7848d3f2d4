"""recompute_block: run a forward segment; recompute it in the backward.

The port of paddle_tpu/ops/recompute_ops.py; core/recompute.py (a copy)
moves each segment between checkpoints into a sub-block behind one
``recompute_block`` op. Forward: the segment's ops run as usual in a
context of their own, so its internal activations leave memory with
that context and only its declared outputs stay. Grad: the segment runs
again with autograd on (``torch.enable_grad`` over detached inputs) and
``torch.autograd.grad`` applies the output cotangents, as
``torch.utils.checkpoint`` does; its activations live only until then.
Plain autograd, not ``torch.func.vjp``: the flash kernels' autograd
Functions (ops/attention.py) hand their kernels plain tensors, which a
functorch transform's wrapped tensors are not.

Randomness replays exactly. Where the JAX package draws one key per
segment and exports it as the ``RngKey`` output, the port records each
random stream the forward drew (``LowerContext.streams``: the seed, or
with a CUDA graph hook its slot) and exports them as ``RngKey`` (a
``SegmentStreams``); the grad's re-run takes them back in order
(``LowerContext.replay``), so its dropout masks are the forward's bit
for bit — in an eager step by the same seeds, and in a replayed CUDA
graph by generators re-seeded with the seeds the forward's slots took
in that replay (core/cuda_graph.py).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..core.autodiff import ATTR_DIFF
from ..core.lowering import LowerContext, lower_ops
from ..core.registry import register_grad_lowering, register_op

__all__ = ["SegmentStreams"]


class SegmentStreams:
    """A segment's ``RngKey`` value: the tokens of the random streams its
    forward drew, in order."""

    __slots__ = ("tokens",)

    def __init__(self, tokens=()):
        self.tokens = tuple(tokens)


def _sub_block(ctx, attrs):
    return ctx.block.program.block(attrs["sub_block"])


def _draws(ctx, attrs) -> bool:
    """Whether the segment's forward draws random streams to record.
    Test mode draws nothing (dropout is identity there), but the
    declared RngKey output still gets a value."""
    return bool(attrs.get("uses_rng")) and not (
        ctx.is_test or attrs.get("is_test", False) or ctx._rng is None)


def _run_segment(ctx, block, in_names, out_names, in_vals, streams=None,
                 replay=None):
    env: Dict[str, Any] = dict(zip(in_names, in_vals))
    sctx = LowerContext(block, ctx._rng, ctx.device, ctx.is_test, ctx.amp,
                        ctx.graph, **ctx.mesh_kw())
    sctx.streams, sctx.replay = streams, replay
    lower_ops(sctx, block.ops, env)
    missing = [n for n in out_names if n not in env]
    if missing:
        raise RuntimeError(
            "recompute segment did not produce declared outputs %s" % missing)
    return [env[n] for n in out_names]


@register_op("recompute_block", diff_inputs=["X"], needs_env=False)
def _recompute_block(ctx, ins, attrs):
    block = _sub_block(ctx, attrs)
    streams = [] if _draws(ctx, attrs) else None
    outs = _run_segment(ctx, block, attrs["input_vars"],
                        attrs["output_vars"], list(ins["X"]), streams)
    res = {"Out": outs}
    if attrs.get("uses_rng"):
        res["RngKey"] = [SegmentStreams(streams or ())]
    return res


@register_grad_lowering("recompute_block")
def _recompute_block_grad(ctx, ins, attrs):
    block = _sub_block(ctx, attrs)
    in_names = attrs["input_vars"]
    out_names = attrs["output_vars"]
    xs = list(ins["X"])[:len(in_names)]
    tokens = ins["RngKey"][0].tokens if attrs.get("uses_rng") else None

    diff = [tuple(d) for d in attrs[ATTR_DIFF]]
    diff_idx = [i for slot, i in diff if slot == "X"]

    # the forward's output values arrive as grad-op inputs (backward.py
    # passes output slots through), which pins down the float outputs —
    # the only ones vjp carries cotangents for
    fwd_outs = list(ins.get("Out") or [])
    float_pos = [i for i, v in enumerate(fwd_outs)
                 if isinstance(v, torch.Tensor) and v.is_floating_point()]

    vals = list(xs)
    leaves = []
    for i in diff_idx:
        vals[i] = xs[i].detach().requires_grad_()
        leaves.append(vals[i])
    replay = None if tokens is None else list(tokens)
    with torch.enable_grad():
        outs = _run_segment(ctx, block, in_names, out_names, vals,
                            replay=replay)
    if replay:
        raise RuntimeError(
            "a recomputed segment drew %d random streams fewer than its "
            "forward drew" % len(replay))

    gouts = ins.get("Out@GRAD") or []
    primals, cots = [], []
    for pos in float_pos:
        pv = outs[pos]
        if not pv.requires_grad:
            continue  # no path from a differentiated input: zero grads
        g = gouts[pos] if pos < len(gouts) else None
        if g is None:
            g = torch.zeros_like(pv)
        elif g.dtype != pv.dtype or g.shape != pv.shape:
            g = torch.broadcast_to(g.to(pv.dtype), pv.shape)
        primals.append(pv)
        cots.append(g)
    dins = (torch.autograd.grad(primals, leaves, cots, allow_unused=True)
            if primals else [None] * len(leaves))

    grads: List[Any] = [None] * len(xs)
    for j, i in enumerate(diff_idx):
        grads[i] = (dins[j] if dins[j] is not None
                    else torch.zeros_like(xs[i]))
    return {"X@GRAD": grads}
