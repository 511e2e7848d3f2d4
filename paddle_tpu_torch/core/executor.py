"""Executor: run a Program block eagerly on one device.

The port's counterpart of paddle_tpu/core/executor.py. The block
analysis is the same (``analyze_block``: feeds, read-only state,
read-write state, write-only persistables, whether the block draws
randomness); the step then runs each op's torch lowering in program
order instead of tracing one XLA computation. There is no pass pipeline,
no plan cache, no jit and no CUDA graph in this version.

    inputs  = feed tensors + persistable state read from the Scope
    outputs = fetches (numpy) + persistable state written back to the Scope

A training Program (``optimizer.minimize``) runs the same way: params,
optimizer moments, beta powers and a learning rate an op writes are
read-write state, written back after the step; grad vars are
temporaries, released after their last reader like any other. Ops
return new tensors, so the scope's tensors are never updated in place.
The RNG chain lives in the scope between runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .lowering import (LowerContext, as_torch_dtype, lower_block,
                       release_schedule)
from .place import Place, default_place, require_device
from .program import Program, Variable, default_main_program, op_effects
from .registry import get_op, has_op
from .scope import Scope, global_scope

__all__ = ["Executor", "analyze_block", "feed_to_device"]

RNG_VAR = "@RNG_STATE@"


class Executor:
    """User-facing executor. ``place=None`` means the card,
    ``CUDAPlace(0)``; pass ``CPUPlace()`` to run on the CPU. Resolving
    the place touches no device; ``run`` raises when the card is asked
    for and absent."""

    def __init__(self, place: Optional[Place] = None):
        self.place = default_place() if place is None else place
        self.device = self.place.torch_device()

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
    ) -> List[np.ndarray]:
        """Run ``program`` on this executor's device; fetches come back
        as numpy arrays."""
        require_device(self.device)
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        block = program.global_block()
        feeds = {n: feed_to_device(n, v, block.vars.get(n), self.device)
                 for n, v in (feed or {}).items()}
        (_, fetch_names, const_state, mut_state, pure_written, needs_rng,
         step) = analyze_block(program, sorted(feeds), fetch_names, scope)
        rng = None
        if needs_rng:
            # a copy: the scope's generator is never advanced in place, so
            # a scope snapshot (a dict of its values) replays the same step
            rng = torch.Generator()
            saved = scope.find_var(RNG_VAR)
            if saved is None:
                seed = program.random_seed \
                    if program.random_seed is not None else 0
                rng.manual_seed(int(seed))
            else:
                rng.set_state(saved.get_state())
        state = {n: _require(scope, n) for n in const_state + mut_state}
        with torch.no_grad():
            fetches, written = step(feeds, state, rng, self.device)
        for n in mut_state + pure_written:
            scope.set_var(n, written[n])
        if needs_rng:
            scope.set_var(RNG_VAR, rng)
        return [v.cpu().numpy() for v in fetches]


def analyze_block(program: Program, feed_names, fetch_names, scope):
    """Classify block vars into feeds / read-only state / read-write
    state / write-only persistables, and build the step function — the
    same classification as the JAX package's ``analyze_block``.

    Returns (feed_names, fetch_names, const_state, mut_state,
    pure_written, needs_rng, step) where
    ``step(feeds, state, rng, device) -> (fetches, written)``; ``written``
    maps every state name in mut_state + pure_written to its new value.
    """
    block = program.global_block()
    feed_names = sorted(feed_names)

    produced = set(feed_names)
    external: List[str] = []
    needs_rng = False
    for op in block.ops:
        if not has_op(op.type):
            raise KeyError("op %r has no registered lowering" % op.type)
        if get_op(op.type).uses_rng:
            needs_rng = True
        reads, writes = op_effects(program, op)
        for n in reads:
            if n not in produced and n not in external:
                external.append(n)
        produced.update(writes)

    written = []
    seen_w = set()
    for op in block.ops:
        for n in op_effects(program, op)[1]:
            if n in seen_w:
                continue
            var = block.vars.get(n)
            persist = (var is not None and var.persistable) or (
                var is None and scope.has_var(n))
            if persist:
                written.append(n)
                seen_w.add(n)

    for n in fetch_names:
        if n not in produced and n not in external:
            external.append(n)  # fetch straight from scope state

    missing = [n for n in external if not scope.has_var(n)]
    if missing:
        raise RuntimeError(
            "uninitialized variables %s: run the startup program first"
            % missing)

    mut_state = [n for n in external if n in seen_w]
    const_state = [n for n in external if n not in seen_w]
    pure_written = [n for n in written if n not in external]

    # temporaries leave the env after their last reader, so the step's
    # peak memory is its live set, not every activation it ever made
    release = release_schedule(
        block.ops, set(fetch_names) | set(mut_state) | set(pure_written))

    def step(feeds, state, rng, device):
        env: Dict[str, Any] = dict(state)
        env.update(feeds)
        ctx = LowerContext(block, rng, device)
        lower_block(ctx, block, env, release)
        missing_f = [n for n in fetch_names if n not in env]
        if missing_f:
            raise KeyError("fetch vars %s were not produced" % missing_f)
        return ([env[n] for n in fetch_names],
                {n: env[n] for n in mut_state + pure_written})

    return (feed_names, fetch_names, const_state, mut_state, pure_written,
            needs_rng, step)


def feed_to_device(name: str, val, var, device: torch.device) -> torch.Tensor:
    """One feed to a tensor on ``device`` at its on-device dtype. int64
    ids narrow to int32 with an explicit range check, as in the JAX
    package (never a silent wraparound)."""
    want = as_torch_dtype(var.dtype) if var is not None else None
    arr = np.asarray(val)
    if arr.size and arr.dtype.kind in "iu" and arr.dtype.itemsize == 8:
        info = np.iinfo(np.int32)
        lo, hi = arr.min(), arr.max()
        if lo < info.min or hi > info.max:
            raise OverflowError(
                "feed %r has values in [%d, %d], outside the device int32 "
                "range [%d, %d]" % (name, lo, hi, info.min, info.max))
        arr = arr.astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=want or t.dtype)


def _require(scope: Scope, name: str):
    v = scope.find_var(name)
    if v is None:
        raise RuntimeError("variable %r is not initialized in scope" % name)
    return v
