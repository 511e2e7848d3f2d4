"""CompiledProgram: the data-parallel compile step.

The port of paddle_tpu/compiler.py (reference: python/paddle/fluid/
compiler.py:62, ``CompiledProgram.with_data_parallel``:116), backed by
the mesh engine (parallel/engine.py). ``Executor.run`` and
``run_repeated`` hand a ``CompiledProgram`` to it, and the engine's
positions default to one per visible device of the executor's kind: the
cards on the card, ``CPU_NUM`` positions on ``CPUPlace()``; ``places``
names them (a place may repeat: positions share a device).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "ParallelExecutor"]


class BuildStrategy:
    """reference details/build_strategy.h — most knobs are subsumed by XLA
    (fusion, memory opt, inplace); the surviving ones configure sharding."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = True   # XLA buffer assignment (always on)
        self.enable_inplace = True    # XLA donation (always on)
        self.fuse_all_reduce_ops = True  # XLA combines collectives
        self.fuse_elewise_add_act_ops = True  # XLA fusion
        self.num_trainers = 1
        self.trainer_id = 0
        self.is_distribution = False


class ExecutionStrategy:
    """reference details/execution_strategy.h — scheduling knobs; the XLA
    runtime schedules internally so these are accepted and recorded."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.use_cuda = False


class CompiledProgram:
    def __init__(self, program):
        self._program = program
        self._is_data_parallel = False
        self._places = None
        self._loss_name = None
        self._build_strategy = None
        self._exec_strategy = None
        self._share_vars_from = None
        self._engine = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None):
        self._is_data_parallel = True
        self._loss_name = loss_name
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._share_vars_from = share_vars_from
        self._places = places
        return self

    def _ensure_engine(self, place=None):
        """Lazily build the ONE mesh engine this program runs through —
        run() and run_repeated() must share it (same compile cache, same
        sharding configuration); its positions on the first executor's
        place unless ``places`` named them."""
        from .parallel.engine import ParallelEngine

        if self._engine is None:
            self._engine = ParallelEngine(
                self._program,
                loss_name=self._loss_name,
                build_strategy=self._build_strategy,
                places=self._places,
                place=place,
            )
        return self._engine

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        if not self._is_data_parallel:
            return executor.run(self._program, feed, fetch_list, scope, return_numpy)
        return self._ensure_engine(executor.place).run(
            feed, fetch_list, scope, return_numpy)

    def _run_repeated(self, executor, feed, fetch_list, scope, steps,
                      return_numpy, feed_stacked, reduce_fetches="last"):
        if not self._is_data_parallel:
            return executor.run_repeated(
                self._program, feed, fetch_list, scope, steps=steps,
                return_numpy=return_numpy, feed_stacked=feed_stacked,
                reduce_fetches=reduce_fetches)
        return self._ensure_engine(executor.place).run_repeated(
            feed, fetch_list, scope, steps=steps,
            return_numpy=return_numpy, feed_stacked=feed_stacked,
            reduce_fetches=reduce_fetches)


class ParallelExecutor:
    """User-facing multi-device executor (reference
    parallel_executor.py:81 — deprecated there in favor of
    CompiledProgram, kept for API parity). Wraps the mesh ParallelEngine:
    feeds split over the data axis, one SPMD executable per feed
    signature."""

    def __init__(self, use_cuda=None, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .core.place import CPUPlace
        from .core.program import default_main_program
        from .core.scope import global_scope
        from .parallel.engine import ParallelEngine

        self._program = main_program or default_main_program()
        if scope is None and share_vars_from is not None:
            # reference semantics: a test-program executor reuses the
            # training executor's variables; here vars live in the scope
            scope = share_vars_from._scope
        self._scope = scope or global_scope()
        build_strategy = build_strategy or BuildStrategy()
        build_strategy.num_trainers = num_trainers
        build_strategy.trainer_id = trainer_id
        self._exec_strategy = exec_strategy
        self._engine = ParallelEngine(
            self._program, loss_name=loss_name,
            build_strategy=build_strategy,
            place=CPUPlace() if use_cuda is False else None)

    @property
    def device_count(self):
        return self._engine.device_count

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        if isinstance(feed, (list, tuple)):
            # per-device pre-split feeds: validate per the reference
            # contract, then concatenate back to the global batch (the
            # engine re-splits over the mesh)
            import numpy as np

            if len(feed) != self.device_count:
                raise ValueError(
                    "Feed a list of tensor, the list should be the same "
                    "size as places (%d), got %d"
                    % (self.device_count, len(feed)))
            if any(not isinstance(d, dict) for d in feed):
                raise TypeError(
                    "Each element of feed list should be a dict")
            merged = {}
            for d in feed:
                for k, v in d.items():
                    merged.setdefault(k, []).append(v)
            feed = {k: np.concatenate(v, axis=0) for k, v in merged.items()}
        return self._engine.run(feed or {}, fetch_list, self._scope,
                                return_numpy)
