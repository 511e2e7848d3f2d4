"""ParallelEngine: one controller running a Program over a mesh of
positions.

The port of paddle_tpu/parallel/engine.py (reference analog:
ParallelExecutor, parallel_executor.cc:184). The JAX engine compiles one
step with sharding annotations and lets XLA's SPMD partitioner place
values and insert collectives; every op keeps the global semantics of
the single-device program, and only three lowerings hold per-device
code (``shard_map`` bodies: the attention ring, ``moe_ffn``'s experts,
the pipeline schedule). The port keeps those semantics with one
controller: the step is the Executor's (core/executor.py), planned,
captured as a CUDA graph on the card and replayed, with the mesh and
its axis names in every op's lowering context. Batch-coupled ops
(``batch_norm``'s statistics, a ``mean`` loss) see the global batch, as
there. The three mesh-aware lowerings run per position, in rounds
(parallel/mesh.py, ring_attention.py, moe.py, pipeline.py).

Across trainer processes (``init_parallel_env``, then a global mesh:
parallel/mesh.py) the ``data`` axis spans the ranks, and the engine
runs what its rank holds: its rows of every feed, the replicated state
(rank 0 broadcasts it at a scope's first step, Fluid's
``BCastParamsToDevices``), and under ZeRO-1 its block of each optimizer
slot. The plan's row propagation (parallel/partition.py) completes the
ops that mix rows with collectives over the process group
(parallel/collective.py), the grads of replicated params all-reduced
through flat buckets before the optimizer; every rank computes what the
single-process program computes, to rounding. Such a plan runs eagerly
at every step: its collectives keep it from a CUDA graph.

Placement follows the rules (``ShardingRules.spec_for`` /
``feed_spec``, with their divisibility check and fall back to
replicated; ``merged_ext_rules`` adds the stacked pipeline / expert
params and ZeRO-1's optimizer slots): each plan records the spec of
every feed and state var, and ``shard`` shows one position's block, a
view of the global value (the positions share one device, so no block
is copied). ``lowered_collectives`` describes a plan's collectives,
where the JAX engine has its partitioned HLO.
"""

from __future__ import annotations

import time
import weakref
from typing import Optional

import torch

from ..core.executor import (Executor, _chain, _check_reduce, _prepare,
                             _require, validate_stacked_feeds)
from ..core.program import Program
from ..core.scope import Scope, global_scope
from .collective import Comm
from .mesh import P, default_places, make_mesh, recording, shard
from .partition import UNCAPTURED_LABEL, Partitioner
from .sharding import ShardingRules

__all__ = ["ParallelEngine", "make_mesh", "merged_ext_rules"]


class _MeshExecutor(Executor):
    """The engine's executor: plans carry the mesh into their lowering
    contexts and record their placement and collectives."""

    def __init__(self, engine: "ParallelEngine"):
        super().__init__(engine.mesh.place)
        self._engine = engine

    def _prepare(self, program, feeds, fetch_names, scope):
        eng = self._engine
        mesh, rules = eng.mesh, eng.rules
        feed_specs = {n: rules.feed_spec(tuple(feeds[n].shape), mesh, name=n)
                      for n in sorted(feeds)}
        ext = merged_ext_rules(eng.program, mesh, rules)
        mesh_kw = dict(mesh=mesh, data_axis=rules.data_axis,
                       model_axis=rules.model_axis, seq_axis=rules.seq_axis)
        if mesh.world > 1:
            mesh_kw["xp"] = Partitioner(eng.comm, rules.data_axis,
                                        feed_specs,
                                        eng._zero1_slots(ext, scope))
        plan = _prepare(program, sorted(feeds), fetch_names, scope,
                        mesh_kw=mesh_kw)
        plan.xplan = getattr(plan.step, "xplan", None)
        if plan.xplan is not None:
            plan.host_sync = sorted(set(plan.host_sync)
                                    | {UNCAPTURED_LABEL})
        plan.feed_specs = {n: feed_specs[n] for n in plan.feed_names}
        # a stacked window's leading K axis stays whole; each step's
        # slice keeps its feed's spec
        plan.window_specs = {n: P(None, *s)
                             for n, s in plan.feed_specs.items()}
        plan.state_specs = {n: ext.spec_for(n, eng._global_shape(n, scope),
                                            mesh)
                            for n in plan.const_state + plan.mut_state}
        plan.collectives = None  # recorded by the plan's first step
        return plan

    def _step(self, plan, program, feeds, scope, eager=False):
        if plan.xplan is not None:
            self._engine._sync_state(plan, scope)
        into = None
        if plan.collectives is None:
            into = plan.collectives = []
        with recording(into):
            return super()._step(plan, program, feeds, scope, eager)


class ParallelEngine:
    """Runs ``program`` over ``mesh`` (default: ``places``, else one
    position per visible device of ``place``'s kind, the card's by
    default; parallel/mesh.py ``default_places``) under ``rules``."""

    def __init__(self, program: Program, loss_name: Optional[str] = None,
                 build_strategy=None, places=None, mesh=None,
                 rules: Optional[ShardingRules] = None, place=None):
        self.program = program
        self.loss_name = loss_name
        self.build_strategy = build_strategy
        if mesh is None:
            mesh = make_mesh(list(places) if places
                             else default_places(place))
        self.mesh = mesh
        self.rules = rules or ShardingRules()
        self.comm = None
        if mesh.world > 1:
            self.comm = _comm(mesh, self.rules.data_axis)
        # per scope, the state names rank 0 has broadcast to it
        self._synced = weakref.WeakKeyDictionary()
        self._exe = _MeshExecutor(self)
        from ..observe.families import ENGINE_DEVICES

        ENGINE_DEVICES.set(self.device_count)

    @property
    def device_count(self) -> int:
        """The mesh's positions (every rank's)."""
        return self.mesh.size

    def _global_shape(self, name, scope):
        """A state var's shape in the single-process program: its
        declared shape (a ZeRO-1 slot's scope tensor holds this rank's
        block), else the scope value's."""
        var = self.program.global_block().vars.get(name)
        shape = getattr(var, "shape", None)
        if shape is not None and getattr(var, "persistable", False) and \
                all(int(d) >= 0 for d in shape):
            return tuple(int(d) for d in shape)
        shape = getattr(scope.find_var(name), "shape", None)
        return None if shape is None else tuple(shape)

    def _zero1_slots(self, ext, scope):
        """The ZeRO-1 slots the data axis splits (``spec_for`` gives them
        P(data)): name -> its global dim 0."""
        out = {}
        for n in sorted(getattr(self.program, "_optimizer_slots", ())):
            shape = self._global_shape(n, scope)
            spec = ext.spec_for(n, shape, self.mesh)
            if shape and spec[:1] == (self.rules.data_axis,):
                out[n] = shape[0]
        return out

    def _sync_state(self, plan, scope):
        """Rank 0's values of the plan's replicated state on every rank,
        once per scope and name (Fluid's ``BCastParamsToDevices`` after
        startup), through flat buckets."""
        done = self._synced.setdefault(scope, set())
        names = [n for n in plan.const_state + plan.mut_state
                 if n not in done and n not in plan.xplan.blocks
                 and isinstance(scope.find_var(n), torch.Tensor)]
        if names:
            vals = self.comm.broadcast_flat([scope.find_var(n)
                                             for n in names])
            for n, v in zip(names, vals):
                scope.set_var(n, v)
            done.update(names)

    @property
    def _cache(self):
        return self._exe._cache

    # ------------------------------------------------------------------ run
    def run(self, feed, fetch_list, scope: Optional[Scope] = None,
            return_numpy: bool = True):
        """One step: the Executor's ``run`` of the program under the
        mesh (on the card a CUDA graph's replay from the plan's second
        run on; ``FLAGS_check_nan_inf`` guards the fetches)."""
        return self._timed("run", lambda: self._exe.run(
            self.program, feed, fetch_list, scope, return_numpy))

    def run_repeated(self, feed, fetch_list, scope: Optional[Scope] = None,
                     steps: int = 1, return_numpy: bool = True,
                     feed_stacked: bool = False,
                     reduce_fetches: str = "last"):
        """K steps in one call, identical to K ``run`` calls (state and
        RNG chain; fetches the last step's, or the window's mean / sum
        with ``reduce_fetches``), as ``Executor.run_repeated``. With
        ``feed_stacked=True`` every feed carries a leading ``steps`` axis
        (one minibatch per step, ``reader.stack_feed_window``); the axis
        stays whole and each step's slice keeps its feed's spec
        (``plan.window_specs``)."""
        _check_reduce(reduce_fetches)
        site = "run_repeated" if steps > 1 else "run"
        return self._timed(site, lambda: self._exe.run_repeated(
            self.program, feed, fetch_list, scope, steps=steps,
            return_numpy=return_numpy, feed_stacked=feed_stacked,
            reduce_fetches=reduce_fetches))

    def _timed(self, site, fn):
        from ..observe.families import ENGINE_DISPATCHES, ENGINE_RUN_SECONDS

        ENGINE_DISPATCHES.labels(site=site).inc()
        t0 = time.perf_counter()
        out = fn()
        ENGINE_RUN_SECONDS.labels(site=site).observe(
            time.perf_counter() - t0)
        return out

    def _plan_for(self, feed, fetch_list, scope: Optional[Scope] = None):
        """(the plan of this feed signature and fetches, prepared where it
        was not; the feeds on the device; the scope)."""
        exe = self._exe
        program, scope, feeds, fetch_names = exe._args(
            self.program, feed, fetch_list, scope)
        return exe._plan(program, feeds, fetch_names, scope), feeds, scope

    def lowered_collectives(self, feed, fetch_list,
                            scope: Optional[Scope] = None, steps: int = 1,
                            feed_stacked: bool = False) -> str:
        """A description of the step's collectives, one line each after
        a line naming the mesh: the counterpart of the JAX engine's
        ``lowered_hlo``, whose HLO this port does not have. Each line is
        one per-position algorithm's collective: its ``kind`` label
        (``ring_ppermute``, ``ppermute``, ``all_gather``,
        ``all_to_all``), axis, positions and details. A plan that has not
        run yet runs its step once on copies of the state (nothing is
        written back) to record them. ``steps`` > 1 describes the K-step
        window: the same step, K times."""
        if steps <= 1 and feed_stacked:
            raise ValueError(
                "steps=1 with feed_stacked has no scanned executable "
                "(run_repeated unstacks and runs the plain step) — "
                "lower the unstacked feed instead")
        feed = feed or {}
        if feed_stacked:
            validate_stacked_feeds(sorted(feed),
                                   [feed[n] for n in sorted(feed)], steps)
            feed = {n: v[0] for n, v in feed.items()}
        plan, feeds, scope = self._plan_for(feed, fetch_list, scope)
        if plan.collectives is None:
            plan.collectives = []
            state = {n: _require(scope, n) for n in plan.const_state}
            state.update((n, _require(scope, n).clone())
                         for n in plan.mut_state)
            chain = _chain(scope, self.program) if plan.needs_rng else None
            with recording(plan.collectives), torch.no_grad():
                plan.step(feeds, state, chain, self._exe.device, None)
        lines = ["mesh %s, %d positions, %d step(s) a call" % (
            ", ".join("%s=%d" % kv for kv in self.mesh.shape.items()),
            self.mesh.size, max(int(steps), 1))]
        for c in plan.collectives:
            extra = " ".join("%s=%s" % (k, v) for k, v in sorted(c.items())
                             if k not in ("kind", "axis", "positions"))
            lines.append(("%s axis=%s positions=%d %s" % (
                c["kind"], c["axis"], c["positions"], extra)).rstrip())
        return "\n".join(lines)

    def shard(self, name: str, position, scope: Optional[Scope] = None):
        """Position ``position``'s block of the state var ``name`` under
        the spec its last plan gave it: a view of the scope's tensor."""
        scope = scope if scope is not None else global_scope()
        spec = None
        for plan in self._cache.values():
            spec = plan.state_specs.get(name, spec)
        if spec is None:
            raise KeyError("%r is no state var of a plan this engine ran"
                           % name)
        t = _require(scope, name)
        if self.mesh.world > 1:
            pos = position if isinstance(position, dict) else dict(
                zip(self.mesh.axis_names, position))
            idx = tuple(int(pos.get(a, 0)) for a in self.mesh.axis_names)
            if not self.mesh.is_local(idx):
                raise ValueError("position %s is held by rank %d, not this "
                                 "one (%d)" % (idx, self.mesh.rank_of(idx),
                                               self.mesh.rank))
            shape = self._global_shape(name, scope)
            if shape and tuple(t.shape) != shape:
                # a ZeRO-1 slot: this rank's block of the data axis
                d = self.mesh.shape[self.rules.data_axis]
                per = shape[0] // d
                first = self.mesh.rank * (d // self.mesh.world)
                return t.narrow(0, (pos.get(self.rules.data_axis, 0)
                                    - first) * per, per)
        return shard(t, spec, self.mesh, position)


def _comm(mesh, data_axis):
    """The process group a cross-process mesh runs over."""
    from .mesh import process_group

    rank, world = process_group()
    if (rank, world) != (mesh.rank, mesh.world):
        raise RuntimeError(
            "a mesh over %d ranks needs init_parallel_env's process group "
            "of as many (this process: rank %d of %d)"
            % (mesh.world, rank, world))
    if data_axis not in mesh.axis_names:
        raise NotImplementedError(
            "a mesh across ranks needs the rules' data axis %r" % data_axis)
    return Comm(rank, world, axis=data_axis,
                positions=mesh.shape[data_axis])


def merged_ext_rules(program, mesh, rules: ShardingRules) -> ShardingRules:
    """User rules + automatic stage/expert sharding: parameters the
    `layers.pipeline` / `layers.moe_ffn` layers created stacked are
    sharded over the 'pipe' / 'expert' mesh axis (leading dim), and —
    via prefix match — so are their optimizer accumulator slots (named
    '<param>_<slot>'; slots whose shape the axis doesn't divide, like
    beta-pow scalars, fall back to replicated inside spec_for). User
    rules are matched first, so an explicit rule for a stacked param
    wins."""
    import re as _re

    ext = []
    for attr, axis in (("_pipeline_params", "pipe"),
                       ("_expert_params", "expert")):
        if axis not in mesh.axis_names:
            continue
        for pname in getattr(program, attr, ()):
            ext.append(("^" + _re.escape(pname), P(axis)))
    # ZeRO-1: one exact-name rule per RECORDED optimizer accumulator
    # (optimizer.py _add_accumulator fills Program._optimizer_slots) —
    # scoping by the program's own records means a user parameter that
    # happens to be named '*_moment_0' can never be swept in. Appended
    # after user rules, so an explicit rule for a slot wins; slots the
    # axis doesn't divide (beta-pow scalars, odd dims) fall back to
    # replicated inside spec_for.
    if getattr(rules, "zero1", False) \
            and rules.data_axis in mesh.axis_names:
        for sname in sorted(getattr(program, "_optimizer_slots", ())):
            ext.append(("^" + _re.escape(sname) + "$",
                        P(rules.data_axis)))
    if not ext:
        return rules
    merged = ShardingRules(data_axis=rules.data_axis,
                           model_axis=getattr(rules, "model_axis", "model"),
                           seq_axis=getattr(rules, "seq_axis", "seq"),
                           zero1=getattr(rules, "zero1", False))
    merged.rules = list(rules.rules) + [
        (_re.compile(pat), spec) for pat, spec in ext]
    merged.feed_rules = list(rules.feed_rules)
    return merged
