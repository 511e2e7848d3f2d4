"""Control-flow ops: ``while`` and ``conditional_block``.

The port of paddle_tpu/ops/control_flow_ops.py, where both compile to
one XLA While / Conditional with no host work. Both lower their
sub-block on a copy of the live env (``needs_env``): the carried state
is every var of the parent env the sub-block writes (the JAX package's
``_written_carry``), handed back through ``__env_update__``.

- ``conditional_block`` reads nothing on the host. Its block always
  runs, on a copy of the env, and each carried var is selected with
  ``torch.where(pred, new, old)``: the values of ``lax.cond``, and a
  step that holds it is captured as a CUDA graph like any other. The
  block's random ops draw on both branches, as the JAX package draws
  its block key on both. A block that updates a tensor in place
  (``kv_cache_write``, the fused optimizer update) is refused: its old
  value would be gone before the select.
- ``while`` reads its condition on the host once per iteration: a trip
  count that depends on data has no other form in a stream of kernels.
  It carries ``host_sync``, so the executor never captures a plan that
  holds it at any depth, and counts and names such a plan
  (core/executor.py); the Predictor so never captures such a bucket.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core.registry import register_op

# ops that update a tensor in place, which a select cannot undo
_IN_PLACE = ("kv_cache_write", "fused_optimizer_update")


def _sub_block(ctx, attrs):
    return ctx.block.program.block(attrs["sub_block"])


def _written_carry(block, env) -> List[str]:
    names: List[str] = []
    for op in block.ops:
        for n in op.output_names():
            if n in env and n not in names:
                names.append(n)
    return names


def _run_body(ctx, block, env, carry: Dict[str, torch.Tensor]):
    """The block on a copy of ``env`` with ``carry`` bound: the new
    values of the carried names."""
    from ..core.lowering import lower_block

    local = dict(env)
    local.update(carry)
    lower_block(ctx.sub(block), block, local)
    return {n: local[n] for n in carry}


@register_op("while", no_grad=True, uses_rng=True, needs_env=True,
             host_sync=True)
def _while(ctx, ins, attrs):
    block = _sub_block(ctx, attrs)
    cond_name = attrs["condition"]
    env = attrs["__env__"]
    carry_names = _written_carry(block, env)
    if cond_name not in carry_names:
        carry_names.append(cond_name)
    carry = {n: env[n] for n in carry_names}
    while bool(carry[cond_name].reshape(())):
        carry = _run_body(ctx, block, env, carry)
    return {"__env_update__": carry}


def _in_place_ops(program, block):
    for op in block.ops:
        if op.type in _IN_PLACE:
            yield op.type
        if "sub_block" in op.attrs:
            yield from _in_place_ops(program,
                                     program.block(op.attrs["sub_block"]))


@register_op("conditional_block", no_grad=True, uses_rng=True,
             needs_env=True)
def _conditional_block(ctx, ins, attrs):
    block = _sub_block(ctx, attrs)
    env = attrs["__env__"]
    bad = sorted(set(_in_place_ops(block.program, block)))
    if bad:
        raise NotImplementedError(
            "conditional_block runs its block on both branches and "
            "selects; %s update a tensor in place, which the select "
            "cannot undo" % bad)
    pred = ins["Cond"][0].reshape(()).to(torch.bool)
    old = {n: env[n] for n in _written_carry(block, env)}
    new = _run_body(ctx, block, env, old)
    out = {}
    for n, v in new.items():
        o = old[n]
        if v.shape != o.shape or v.dtype != o.dtype:
            raise TypeError(
                "conditional_block: %r is %s %s before the block and %s "
                "%s after it; both branches must give it one shape and "
                "dtype" % (n, tuple(o.shape), o.dtype, tuple(v.shape),
                           v.dtype))
        out[n] = torch.where(pred, v, o)
    return {"__env_update__": out}
