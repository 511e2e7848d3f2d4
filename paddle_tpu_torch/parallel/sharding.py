"""Sharding rules: var-name pattern -> PartitionSpec over the mesh.

This is the TPU-native replacement for the reference's graph-builder pass
(details/multi_devices_graph_pass.cc): instead of rewriting the graph with
broadcast/all-reduce op handles per variable, each variable gets a
PartitionSpec annotation and XLA's SPMD partitioner derives the collective
schedule. Rules are (regex, spec) pairs matched in order; unmatched vars
are replicated (the data-parallel default, = BCastParamsToDevices at
parallel_executor.cc:355 without the explicit ncclBcast).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from .mesh import Mesh, NamedSharding, P

__all__ = ["ShardingRules", "P"]


class ShardingRules:
    def __init__(self, rules: Optional[Sequence[Tuple[str, P]]] = None,
                 data_axis: str = "data",
                 feed_rules: Optional[Sequence[Tuple[str, P]]] = None,
                 model_axis: str = "model", seq_axis: str = "seq",
                 zero1: bool = False):
        self.rules: List[Tuple[re.Pattern, P]] = [
            (re.compile(pat), spec) for pat, spec in (rules or [])
        ]
        # per-feed specs by name pattern (e.g. sequence parallelism:
        # ids [B, S] as P("data", "seq")); unmatched feeds batch-shard
        self.feed_rules: List[Tuple[re.Pattern, P]] = [
            (re.compile(pat), spec) for pat, spec in (feed_rules or [])
        ]
        self.data_axis = data_axis
        # the tensor-parallel axis name: ops that shard_map kernels
        # (fused attention) shard heads over it when it divides
        self.model_axis = model_axis
        # the sequence-parallel axis: fused attention rides ring
        # attention over it (ops/attention.py)
        self.seq_axis = seq_axis
        # ZeRO-1: optimizer accumulators shard their leading dim over
        # the data axis (each device keeps 1/N of every moment; XLA
        # inserts the gather that reassembles updated params). Exact
        # same numerics — the memory/collective trade is the point.
        # Applied by the engine (merged_ext_rules) against the
        # program's RECORDED accumulator names (Program._optimizer_
        # slots), never a name heuristic; user rules always win.
        self.zero1 = zero1

    def add(self, pattern: str, spec: P) -> "ShardingRules":
        self.rules.append((re.compile(pattern), spec))
        return self

    def add_feed(self, pattern: str, spec: P) -> "ShardingRules":
        self.feed_rules.append((re.compile(pattern), spec))
        return self

    def spec_for(self, name: str, shape, mesh: Mesh) -> P:
        """Spec for a state var. Falls back to replicated when no rule
        matches or the matched spec doesn't divide the shape. (The
        zero1 slot rules arrive as ordinary low-priority rules from
        merged_ext_rules, which knows the program's accumulator names —
        scalar slots like beta-pow don't divide and stay replicated.)"""
        for pat, spec in self.rules:
            if pat.search(name):
                if _divides(spec, shape, mesh):
                    return spec
                break
        return P()

    def feed_spec(self, shape, mesh: Mesh, name: str = "") -> P:
        """Spec for one feed. A matching feed_rule wins (sequence/context
        parallelism shards the time axis too); otherwise batch-shard on
        dim 0 (FeedAndSplitTensorIntoLocalScopes analog,
        parallel_executor.cc:468): the user feeds the global batch and it
        is split across the data axis of the mesh."""
        for pat, spec in self.feed_rules:
            if name and pat.search(name):
                if _divides(spec, shape, mesh):
                    return spec
                break
        if self.data_axis not in mesh.axis_names:
            return P()
        n = mesh.shape[self.data_axis]
        if len(shape) >= 1 and shape[0] % n == 0 and shape[0] > 0:
            return P(self.data_axis)
        return P()

    def sharding(self, name: str, shape, mesh: Mesh) -> NamedSharding:
        return NamedSharding(mesh, self.spec_for(name, shape, mesh))


def _divides(spec: P, shape, mesh: Mesh) -> bool:
    if shape is None or len(spec) > len(shape):
        return False
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        k = 1
        for a in axes:
            k *= mesh.shape[a]
        if dim % k != 0:
            return False
    return True
