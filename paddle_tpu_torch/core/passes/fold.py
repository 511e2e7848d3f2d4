"""Constant folding: evaluate const-only subgraphs at optimize time.

The port of paddle_tpu/core/passes/fold.py. Ops whose every input is
itself a compile-time constant (transitively rooted in attr-only
producers like ``fill_constant`` / ``assign_value``) are EXECUTED once,
eagerly, through their own registered torch lowerings on CPU tensors —
the single source of op semantics, so a folded value is bitwise the
value the program would have computed — and the surviving reads are
served by one ``assign_value`` op per still-consumed var.

The one difference from the JAX package is the value type: there a
lowering runs through ``jax.numpy`` on numpy values; here it runs with
the port's ``LowerContext`` (no block, no RNG, the CPU) on CPU tensors,
which the pass keeps as its folded values (numpy has no bfloat16). A
Program with bf16 AMP on folds under the same per-op casts
(core/amp.py ``amp_cast``) its lowering would apply, so a folded value
is bitwise the value AMP computes, bf16 where AMP computes bf16.

Folding is skipped wholesale when it would not shrink the op count
(replacing one ``fill_constant`` with one ``assign_value`` is churn,
not optimization), and capped at ``PADDLE_TPU_OPTIMIZE_FOLD_MAX_ELEMS``
elements per op output (default 16384) so a giant folded table never
bloats the program description.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from ..amp import amp_cast
from ..ir import Graph, Pass, register_pass
from ..lowering import LowerContext
from ..registry import get_op
from .common import (ELEMENTWISE_BINARY, ELEMENTWISE_UNARY,
                     single_output_name)

# op types worth evaluating at optimize time: the shared elementwise
# vocabulary plus attr-only constant sources and deterministic
# shape/reduction arithmetic. Anything outside this list stays in the
# graph even if its inputs are constant (convs/matmuls over constants
# are better left to XLA's own folder than materialized into the
# program text).
FOLDABLE_OPS = ELEMENTWISE_UNARY | ELEMENTWISE_BINARY | frozenset({
    "fill_constant", "assign_value", "fill_any_like", "assign",
    "share_data", "range", "shape", "one_hot", "linspace",
    "reshape", "transpose", "concat", "stack", "squeeze", "unsqueeze",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
})


def fold_max_elems() -> int:
    # malformed input falls back like optimize_level(): config_key()
    # calls this from the executor's cache key on EVERY run, so a typo'd
    # env var must not crash the step loop
    try:
        return int(os.environ.get("PADDLE_TPU_OPTIMIZE_FOLD_MAX_ELEMS",
                                  "16384"))
    except ValueError:
        return 16384


@register_pass("constant_folding_pass")
class ConstantFoldingPass(Pass):
    """Evaluate const-only subgraphs once at optimize time and replace
    them with ``assign_value`` ops carrying the results (see module
    docstring for the exact safety conditions)."""

    fetch_names = frozenset()
    scope = None

    def apply(self, graph: Graph) -> Graph:
        from .common import Dataflow

        program = graph.program
        amp = bool(getattr(program, "amp", False))
        df = Dataflow(program, fetch_names=self.fetch_names,
                      scope=self.scope)
        fetch = set(self.fetch_names or ())
        cap = fold_max_elems()
        self.rewrites = []

        const_env: Dict[str, torch.Tensor] = {}
        foldable = []  # op nodes, program order
        for node in graph.op_nodes:
            op = node.op
            if op.type not in FOLDABLE_OPS or not df.is_pure(op):
                continue
            in_names = [n for n in op.input_names() if n]
            if any(n not in const_env for n in in_names):
                continue
            out = single_output_name(op)
            # fetched outputs ARE still foldable (the assign_value keeps
            # the name alive), so check removability with the fetch
            # guard waived — same engine predicate as everyone else,
            # minus that one rule
            if out is None or not df.removable_output(
                    out, ignore_fetch=True):
                continue
            val = self._evaluate(op, const_env, amp)
            if val is None or val.numel() > cap:
                continue
            const_env[out] = val
            foldable.append(node)

        if not foldable:
            self.stats = {"folded": 0}
            self.changed = False
            return graph

        folded_ids = {id(n) for n in foldable}
        # materialize a const var iff something SURVIVING still reads it
        # (a top-level consumer outside the folded set, or a fetch)
        need = set()
        for node in foldable:
            out = single_output_name(node.op)
            if out in fetch:
                need.add(out)
                continue
            for vn in node.outputs:
                if any(id(c) not in folded_ids for c in vn.outputs):
                    need.add(out)
                    break
        if len(foldable) <= len(need):
            self.stats = {"folded": 0}  # churn, not a win
            self.changed = False
            return graph

        for node in foldable:
            graph.remove_op_node(node)
            self.rewrites.append({"kind": "remove", "op": node.op})
        for name in sorted(need):
            val = const_env[name]
            srcs = [n.op for n in foldable
                    if single_output_name(n.op) == name]
            new_node = graph.insert_op_node(
                "assign_value", {}, {"Out": [name]},
                attrs={"values": val.ravel().tolist(),
                       "shape": list(val.shape),
                       "dtype": str(val.dtype).replace("torch.", "")},
                provenance_from=srcs)
            self.rewrites.append({"kind": "materialize",
                                  "into": new_node.op, "name": name,
                                  "from": srcs})
        self.stats = {"folded": len(foldable), "materialized": len(need)}
        self.changed = True
        return graph

    @staticmethod
    def _evaluate(op, const_env, amp):
        """Run one op's registered lowering eagerly on concrete values.
        Any failure means "don't fold", never "fail the program"."""
        try:
            ins = {slot: [const_env[n] if n else None for n in names]
                   for slot, names in op.inputs.items()}
            if amp:
                ins = amp_cast(op.type, op.attrs, ins)
            ctx = LowerContext(block=None, rng=None,
                               device=torch.device("cpu"), amp=amp)
            with torch.no_grad():
                outs = get_op(op.type).lowering(ctx, ins, dict(op.attrs))
            slot = next(s for s, ns in op.outputs.items()
                        if any(ns))
            val = outs.get(slot)
            if isinstance(val, (list, tuple)):
                val = val[0]
            if not isinstance(val, torch.Tensor):
                return None
            return val
        except Exception:
            return None
