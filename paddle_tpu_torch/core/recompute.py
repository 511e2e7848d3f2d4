"""Recompute (gradient checkpointing) program surgery.

Reference analog: fluid's RecomputeOptimizer (a later-era
python/paddle/fluid/optimizer.py feature; the v1.3 snapshot's closest
machinery is ir/multi_batch_merge_pass.cc-style program cloning). The
reference implements recompute by *duplicating forward op descs into the
backward section* of the program. The TPU-native design instead moves
each forward segment into a sub-block behind one `recompute_block` op:

- forward lowering runs the segment normally (one emission);
- the synthesized grad op re-traces the segment behind an
  `optimization_barrier` on its inputs, so XLA cannot CSE the re-trace
  against the forward emission and schedules it in the backward region —
  i.e. true rematerialization: segment-internal activations are dead
  after the forward pass and recomputed when the grads need them.

Randomness replays exactly: the forward draws ONE PRNG key per segment,
exports it as an op output (`RngKey`), and the grad op re-seeds the
segment's lowering context with that same key, so dropout masks in the
recomputed pass match the forward pass bit-for-bit.

Call :func:`apply_recompute` on the forward-only program (before
append_backward) — RecomputeOptimizer.minimize does this.
"""

from __future__ import annotations

from typing import List, Sequence

from .program import Operator, Program, Variable
from .registry import get_op
from .. import unique_name

__all__ = ["apply_recompute"]

RNG_KEY_SUFFIX = "@RECOMPUTE_RNG"


def _op_reads(op, program) -> List[str]:
    """All names an op reads, recursing into control-flow sub-blocks."""
    reads = list(op.input_names())
    if "sub_block" in op.attrs:
        sub = program.block(op.attrs["sub_block"])
        bound = set(op.attrs.get("__sub_bound__", ()))
        for sop in sub.ops:
            reads.extend(n for n in _op_reads(sop, program) if n not in bound)
            bound.update(sop.output_names())
        cond = op.attrs.get("condition")
        if cond:
            reads.append(cond)
    return reads


def _op_writes(op, program) -> List[str]:
    writes = list(op.output_names())
    if "sub_block" in op.attrs:
        sub = program.block(op.attrs["sub_block"])
        for sop in sub.ops:
            writes.extend(_op_writes(sop, program))
    return writes


def segment_uses_rng(ops, program) -> bool:
    for op in ops:
        if get_op(op.type).uses_rng:
            return True
        if "sub_block" in op.attrs and segment_uses_rng(
                program.block(op.attrs["sub_block"]).ops, program):
            return True
    return False


def apply_recompute(program: Program, checkpoints: Sequence) -> int:
    """Wrap the op ranges between checkpoint vars into recompute_block ops.

    ``checkpoints``: Variables (or names) whose values are *stored*; the
    ops between consecutive checkpoints form segments whose internals are
    rematerialized in the backward pass. The tail after the last
    checkpoint stays unwrapped (its activations are needed immediately
    when the backward starts, so recomputing them saves nothing).

    Returns the number of segments wrapped. Must run on the forward-only
    program, before append_backward.
    """
    block = program.global_block()
    names = [c.name if isinstance(c, Variable) else str(c) for c in checkpoints]
    if any(op.attrs.get("__op_role__") == "backward" for op in block.ops):
        raise RuntimeError(
            "apply_recompute must run before append_backward "
            "(RecomputeOptimizer.minimize does this in the right order)")

    producer = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            producer[n] = i
    missing = [n for n in names if n not in producer]
    if missing:
        raise ValueError(
            "recompute checkpoints %s are not produced by any op in the "
            "program" % missing)

    cuts = sorted({producer[n] for n in names})
    ops = list(block.ops)
    # segments are [start, cut] inclusive; a trailing non-checkpoint
    # region is intentionally left alone (see docstring)
    segments, start = [], 0
    for cut in cuts:
        if cut - start >= 1:  # >= 2 ops: wrapping a single op is pure cost
            segments.append((start, cut))
        start = cut + 1

    # reads of everything AFTER a segment decide which writes must escape
    suffix_reads: List[set] = [set()] * (len(ops) + 1)
    acc: set = set()
    for i in range(len(ops) - 1, -1, -1):
        acc = acc | set(_op_reads(ops[i], program))
        suffix_reads[i] = acc

    wrapped = 0
    new_ops: List = []
    pos = 0
    for (s, e) in segments:
        new_ops.extend(ops[pos:s])
        seg_ops = ops[s:e + 1]

        inputs: List[str] = []
        written: set = set()
        outputs: List[str] = []
        for op in seg_ops:
            for n in _op_reads(op, program):
                if n and n not in written and n not in inputs:
                    inputs.append(n)
            for n in _op_writes(op, program):
                if not n:
                    continue
                written.add(n)
                var = block.vars.get(n)
                persist = var is not None and var.persistable
                if (persist or n in suffix_reads[e + 1]) and n not in outputs:
                    outputs.append(n)

        sub = program.create_block(parent_idx=block.idx)
        program.rollback()
        for op in seg_ops:
            op.block = sub
            sub.ops.append(op)

        out_slots = {"Out": outputs}
        attrs = {
            "sub_block": sub.idx,
            "input_vars": list(inputs),
            "output_vars": list(outputs),
            "__sub_bound__": list(inputs),
        }
        if segment_uses_rng(seg_ops, program):
            rng_name = unique_name.generate("recompute" + RNG_KEY_SUFFIX)
            block.create_var(name=rng_name, shape=[], dtype="float32",
                             persistable=False)
            out_slots = {"Out": outputs, "RngKey": [rng_name]}
            attrs["uses_rng"] = True
        new_ops.append(Operator(block, "recompute_block",
                                {"X": inputs}, out_slots, attrs))
        wrapped += 1
        pos = e + 1
    new_ops.extend(ops[pos:])

    if wrapped:
        block.ops = new_ops
        program._bump()
    return wrapped
