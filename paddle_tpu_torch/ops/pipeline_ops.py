"""pipeline op: the GPipe-schedule stage stack as one graph op.

The port of paddle_tpu/ops/pipeline_ops.py. ``layers.pipeline`` builds
one stage's computation into a sub-block whose parameters are created
stacked with a leading [n_stages] dim; this lowering then either

  - runs the stages over the mesh's 'pipe' axis with ``pipeline_apply``
    (stage s at position s, activations hopping stage to stage, the
    microbatches overlapping) when the engine's mesh has one, or
  - applies the stages in turn (the same math: stages are per-sample
    maps, so microbatch boundaries do not change the result) on one
    device or a mesh without a pipe axis.

Under a (data, pipe) mesh the microbatch rows split over the data axis
where it divides them, as in the JAX package; the data positions of a
pipe position share its device, so they run as one computation.

Stochastic stage bodies (dropout): the forward draws one stream from the
chain and exports its token as ``RngKey`` (recompute's
``SegmentStreams``); stage s on microbatch m draws from a chain folded
from it with s * n_mb + m (``core.lowering.FoldedChain``, the
counterpart of ``jax.random.fold_in``), so its masks depend on the pair
and not on the schedule that ran it. The sequential fallback
microbatches a stochastic body too, so the pipelined and sequential
paths draw the same masks bit for bit, under a (data, pipe) mesh as
well (where the JAX package folds in the data index and draws another
realization). The grad re-runs the forward with autograd on from the
same token (recompute's pattern), so its masks are the forward's.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..core.lowering import FoldedChain, LowerContext, lower_ops
from ..core.registry import register_grad_lowering, register_op
from .recompute_ops import SegmentStreams

__all__: List[str] = []


def _stage_fn(ctx, sub, slice_names, in_name, out_name, mesh_kw):
    def stage(param_slices, x, rng=None):
        env: Dict[str, Any] = dict(zip(slice_names, param_slices))
        env[in_name] = x
        sctx = LowerContext(sub, ctx._rng if rng is None else rng,
                            ctx.device, ctx.is_test, ctx.amp, ctx.graph,
                            **mesh_kw)
        lower_ops(sctx, sub.ops, env)
        return env[out_name]

    return stage


def _microbatches(x, n_mb):
    B = x.shape[0]
    if B % n_mb:
        raise ValueError(
            "pipeline batch %d is not divisible by n_microbatches=%d"
            % (B, n_mb))
    return x.reshape((n_mb, B // n_mb) + tuple(x.shape[1:]))


def _apply_pipeline(ctx, x, stacked, attrs, token):
    """Forward computation shared by the op lowering and its grad
    replay. ``token`` is None for deterministic bodies; otherwise the
    drawn (forward) or replayed (backward) stream's token."""
    n_stages = int(attrs["n_stages"])
    n_mb = int(attrs["n_microbatches"])
    axis = attrs.get("axis", "pipe")
    sub = ctx.block.program.block(attrs["sub_block"])
    names = (attrs["slice_names"], attrs["in_name"], attrs["out_name"])

    mesh = ctx.mesh
    use_pipe = mesh is not None and axis in mesh.axis_names \
        and mesh.shape[axis] > 1
    if use_pipe and mesh.shape[axis] != n_stages:
        raise ValueError(
            "pipeline op with n_stages=%d under a mesh whose %r axis has "
            "%d devices — stages map one-per-device; reshape the mesh or "
            "the stage count" % (n_stages, axis, mesh.shape[axis]))
    fold = lambda s, m: FoldedChain(token, (s * n_mb + m,))  # noqa: E731

    if not use_pipe:
        stage = _stage_fn(ctx, sub, *names, ctx.mesh_kw())
        if token is None:
            # sequential fallback: same per-sample math, no microbatching
            out = x
            for s in range(n_stages):
                out = stage([p[s] for p in stacked], out)
            return out
        # stochastic body: microbatch as the pipelined path does, each
        # (stage, microbatch) on its own folded chain
        mbs = list(_microbatches(x, n_mb))
        for s in range(n_stages):
            params_s = [p[s] for p in stacked]
            mbs = [stage(params_s, mb, fold(s, m))
                   for m, mb in enumerate(mbs)]
        return torch.stack(mbs).reshape(x.shape)

    from ..parallel.pipeline import pipeline_apply

    x_mb = _microbatches(x, n_mb)
    # dp x pp: the microbatch rows split over the data axis where it
    # divides them; those positions' rows run together
    data_axis = ctx.data_axis
    data = mesh.shape[data_axis] if (
        data_axis in mesh.axis_names and mesh.shape[data_axis] > 1
        and x_mb.shape[1] % mesh.shape[data_axis] == 0) else 1
    # a stage's body runs at one position: it holds no per-position
    # algorithm of its own
    stage = _stage_fn(ctx, sub, *names, {})
    stages = [(s, [p[s] for p in stacked]) for s in range(n_stages)]
    if token is None:
        out_mb = pipeline_apply(lambda sp, xi: stage(sp[1], xi), stages,
                                x_mb, axis, data_positions=data)
    else:
        out_mb = pipeline_apply(
            lambda sp, xi, mb: stage(sp[1], xi, fold(sp[0], mb)), stages,
            x_mb, axis, mb_arg=True, data_positions=data)
    return out_mb.reshape(x.shape)


@register_op("pipeline", diff_inputs=["X", "StackedParams"],
             needs_env=False, uses_rng=True)
def _pipeline(ctx, ins, attrs):
    x = ins["X"][0]
    stacked = list(ins["StackedParams"])
    token = None
    if attrs.get("uses_rng") and not (ctx.is_test
                                      or attrs.get("is_test", False)):
        # next_token() raises in a pure context by design: only this
        # op's own grad replays the stream
        token = ctx.next_token()
    out = _apply_pipeline(ctx, x, stacked, attrs, token)
    res = {"Out": [out]}
    if attrs.get("uses_rng"):
        res["RngKey"] = [SegmentStreams(() if token is None else (token,))]
    return res


@register_grad_lowering("pipeline")
def _pipeline_grad(ctx, ins, attrs):
    """The forward re-run with autograd on, from the same stream (its
    masks the forward's), and ``torch.autograd.grad`` of its output."""
    x = ins["X"][0]
    stacked = list(ins["StackedParams"])
    token = None
    if attrs.get("uses_rng"):
        tokens = ins["RngKey"][0].tokens
        token = tokens[0] if tokens else None
    leaves = [t.detach().requires_grad_() for t in [x] + stacked]
    with torch.enable_grad():
        out = _apply_pipeline(ctx, leaves[0], leaves[1:], attrs, token)
    g = (ins.get("Out@GRAD") or [None])[0]
    if g is None:
        g = torch.zeros_like(out)
    elif g.dtype != out.dtype or g.shape != out.shape:
        g = torch.broadcast_to(g.to(out.dtype), out.shape)
    grads = torch.autograd.grad([out], leaves, [g], allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for d, t in zip(grads, leaves)]
    return {"X@GRAD": [grads[0]], "StackedParams@GRAD": grads[1:]}
