"""Inference engine: load -> rewrite for inference -> serve by bucket.

The port's counterpart of paddle_tpu/inference/__init__.py:
``AnalysisConfig``, ``Predictor`` (bucket routing and warmup),
``create_paddle_predictor`` and ``_rewrite_for_inference``. Requests
run eagerly through the port's Executor on the card, unless the config
says ``disable_gpu()`` (the reference name, paddle_analysis_config.h) or
``from_program`` is given ``place=CPUPlace()``. On the card each
warm-up bucket's plan is captured as a CUDA graph at load, and every
request of a bucket is one replay (core/cuda_graph.py). A Predictor
from a deployable artifact (``export.load_artifact(...).predictor()``)
serves a bucket through the artifact's AOT section when it has one
(``_run_aot``, counted in ``paddle_export_artifact_aot_calls_total``).
The JAX package's serving metrics (bucket hits and padding) are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.place import CPUPlace, CUDAPlace, Place
from ..core.program import Program
from ..core.scope import Scope

__all__ = ["AnalysisConfig", "Predictor", "create_paddle_predictor",
           "create_predictor_from_dir", "PaddleTensor"]


def batch_major(var) -> bool:
    """True when the var's leading dim is dynamic (the batch axis): the
    predicate for "rows of this tensor belong to individual requests"."""
    shape = getattr(var, "shape", None)
    return bool(shape) and (shape[0] is None or shape[0] < 0)


class AnalysisConfig:
    """Predictor configuration (api/paddle_analysis_config.h analog)."""

    def __init__(self, model_dir: Optional[str] = None,
                 model_filename: Optional[str] = None,
                 params_filename: Optional[str] = None):
        self.model_dir = model_dir
        self.model_filename = model_filename
        self.params_filename = params_filename
        # batch-size buckets run once at init; requests pad up to the
        # nearest one. Empty = every request runs at its own batch size
        self.warmup_batch_sizes: List[int] = []
        self.use_gpu = True

    def disable_gpu(self) -> "AnalysisConfig":
        """Serve on the CPU. Returns the config, so it can be passed on
        in the same expression."""
        self.use_gpu = False
        return self

    def place(self) -> Place:
        return CUDAPlace(0) if self.use_gpu else CPUPlace()


class PaddleTensor:
    """Named tensor crossing the predictor boundary (api/paddle_api.h
    PaddleTensor analog): a numpy array and its feed name."""

    def __init__(self, name: str, data: np.ndarray):
        self.name = name
        self.data = np.asarray(data)

    @property
    def shape(self):
        return self.data.shape


class Predictor:
    """AnalysisPredictor analog: owns a Scope with the loaded params and
    an Executor on the config's place."""

    def __init__(self, config: AnalysisConfig):
        from ..core.executor import Executor
        from ..io import load_inference_model

        self.config = config
        self.scope = Scope()
        self._exe = Executor(config.place())
        program, feeds, fetches = load_inference_model(
            config.model_dir, self._exe,
            model_filename=config.model_filename,
            params_filename=config.params_filename,
            scope=self.scope)
        self.program: Program = _rewrite_for_inference(program)
        self.feed_names: List[str] = list(feeds)
        self.fetch_vars = fetches
        self.fetch_names = [v.name for v in fetches]
        self._buckets: List[int] = sorted(set(
            int(b) for b in config.warmup_batch_sizes))
        for bs in self._buckets:
            self._warmup(bs)

    @classmethod
    def from_program(cls, program: Program, feed_names: Sequence[str],
                     fetch_names: Sequence[str], params: Dict[str, object],
                     warmup_batch_sizes: Sequence[int] = (),
                     place: Optional[Place] = None,
                     batch_major_fetches: Sequence[str] = (),
                     pre_optimized: bool = False):
        """Build a Predictor from an in-memory Program and its parameters
        (for example ``convert.params_from_jax``'s output, or a dygraph
        capture's state: ``CapturedFunction.as_predictor``), with no
        save/load round trip. ``place=None`` serves on the card.
        ``batch_major_fetches`` names fetch vars whose lead dim is the
        batch axis (a capture records them with the trace's concrete
        batch; the bucket router needs the dynamic -1 marker to slice
        pad rows back off).

        ``pre_optimized`` is the artifact path (``export.load_artifact``):
        the program was ALREADY inference-rewritten + pipeline-optimized
        at save time, so the rewrite and the batch-major marking are
        skipped and the program serves as-is (its ``_pre_optimized``
        flag makes the executor skip the pass pipeline too)."""
        from ..core.executor import Executor

        self = cls.__new__(cls)
        config = AnalysisConfig()
        config.warmup_batch_sizes = list(warmup_batch_sizes)
        self.config = config
        self.scope = Scope()
        self._exe = Executor(place)
        for n, v in params.items():
            self.scope.set_var(n, v)
        self.program = (program if pre_optimized
                        else _rewrite_for_inference(program))
        block = self.program.global_block()
        if not pre_optimized:
            for n in batch_major_fetches:
                var = block.vars.get(n)
                if var is not None and var.shape:
                    var.shape = (-1,) + tuple(var.shape[1:])
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.fetch_vars = [block.var(n) for n in fetch_names]
        self._buckets = sorted(set(int(b) for b in warmup_batch_sizes))
        for bs in self._buckets:
            self._warmup(bs)
        return self

    # ------------------------------------------------------------- serving
    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)

    def run(self, inputs) -> List[np.ndarray]:
        """inputs: list of PaddleTensor / list of arrays in feed order /
        dict name->array. Returns fetch arrays.

        Batch sizes route through the ``warmup_batch_sizes`` buckets: an
        unseen size pads up to the nearest bucket and the pad rows are
        sliced back off the results; a batch larger than every bucket
        runs at its own size.

        Artifact-loaded predictors carry ``torch.export`` programs per
        bucket (``export.load_artifact``): a run whose routed batch
        matches an AOT bucket calls the frozen program (on the card a
        replay of its CUDA graph), counted in
        ``paddle_export_artifact_aot_calls_total``; anything else falls
        through to the executor plan path."""
        feed = self._as_feed(inputs)
        feed, n_rows = self._route_bucket(feed)
        outs = self._run_aot(feed)
        if outs is None:
            outs = self._exe.run(self.program, feed=feed,
                                 fetch_list=self.fetch_names,
                                 scope=self.scope)
        if n_rows is not None:
            outs = [o[:n_rows] if batch_major(v) else o
                    for v, o in zip(self.fetch_vars, outs)]
        return outs

    def _run_aot(self, feed):
        """Serve one routed feed from the artifact's AOT section, or
        None when no frozen program covers it (no ``_aot`` map, batch
        not a frozen bucket, or feed names diverged)."""
        aot = getattr(self, "_aot", None)
        if not aot:
            return None
        block = self.program.global_block()
        sizes = {np.shape(feed[n])[0] for n in feed
                 if batch_major(block.vars.get(n))}
        if len(sizes) != 1:
            return None
        runner = aot.get(next(iter(sizes)))
        if runner is None or set(runner.feed_names) != set(feed):
            return None
        from ..observe.families import ARTIFACT_AOT_CALLS

        outs = runner(feed)
        ARTIFACT_AOT_CALLS.inc()
        if list(runner.out_names) != list(self.fetch_names):
            order = {n: i for i, n in enumerate(runner.out_names)}
            outs = [outs[order[n]] for n in self.fetch_names]
        return outs

    __call__ = run

    def bucket_for(self, batch_size: int) -> Optional[int]:
        """Smallest warmup bucket >= batch_size, or None when the batch
        overflows every bucket (or none are configured)."""
        for b in self._buckets:
            if b >= batch_size:
                return b
        return None

    def _route_bucket(self, feed):
        """Pad batch-major feeds up to the nearest warmup bucket.
        Returns (feed, n_rows): n_rows is None when nothing was padded
        (exact bucket hit, bucket overflow, or no buckets/batch dim)."""
        if not self._buckets:
            return feed, None
        block = self.program.global_block()
        batch_names = [n for n in feed if batch_major(block.vars.get(n))]
        if not batch_names:
            return feed, None
        sizes = {np.asarray(feed[n]).shape[0] for n in batch_names}
        if len(sizes) != 1:
            raise ValueError(
                "inconsistent batch sizes across feeds: %s"
                % ({n: np.asarray(feed[n]).shape for n in batch_names},))
        (b,) = sizes
        bucket = self.bucket_for(b)
        if bucket is None or bucket == b:
            return feed, None
        pad = bucket - b
        out = dict(feed)
        for n in batch_names:
            arr = np.asarray(feed[n])
            out[n] = np.concatenate(
                [arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)])
        return out, b

    def _as_feed(self, inputs) -> Dict[str, np.ndarray]:
        known = set(self.feed_names)
        if isinstance(inputs, dict):
            unknown = sorted(set(inputs) - known)
            if unknown:
                raise ValueError(
                    "unknown feed name(s) %s — this predictor's inputs "
                    "are %s" % (unknown, self.feed_names))
            return dict(inputs)
        if isinstance(inputs, (list, tuple)):
            vals = [t.data if isinstance(t, PaddleTensor) else t
                    for t in inputs]
            if inputs and all(isinstance(t, PaddleTensor)
                              for t in inputs):
                names = [t.name for t in inputs]
                unknown = sorted(set(names) - known)
                if unknown:
                    raise ValueError(
                        "unknown feed name(s) %s — this predictor's "
                        "inputs are %s" % (unknown, self.feed_names))
                if len(set(names)) != len(names):
                    raise ValueError("duplicate feed names in inputs: %s"
                                     % (names,))
            else:
                names = self.feed_names
                if len(vals) != len(names):
                    raise ValueError(
                        "got %d positional inputs for %d feeds %s — "
                        "pass one array per feed (or PaddleTensors / a "
                        "name->array dict)" % (len(vals), len(names),
                                               self.feed_names))
            return dict(zip(names, vals))
        return {self.feed_names[0]: inputs}

    def _warmup(self, batch_size: int):
        """Run zero feeds at one bucket's batch size once, so the first
        request of that size pays no first-call cost (kernel build,
        allocator growth), and on the card twice: the second run
        captures that bucket's CUDA graph, so the first request is a
        replay."""
        feed = {}
        block = self.program.global_block()
        for n in self.feed_names:
            var = block.var(n)
            shape = [batch_size if (s is None or s < 0) else s
                     for s in (var.shape or ())]
            feed[n] = np.zeros(shape, dtype=var.dtype)
        for _ in range(2 if self._exe.device.type == "cuda" else 1):
            self._exe.run(self.program, feed=feed,
                          fetch_list=self.fetch_names, scope=self.scope)


def _rewrite_for_inference(program: Program) -> Program:
    """OptimizeInferenceProgram analog: flip train-only attrs to test mode
    (dropout scales by 1 - p, batch_norm uses running stats)."""
    p = program.clone(for_test=True)
    for b in p.blocks:
        for op in b.ops:
            if op.type in ("dropout", "batch_norm"):
                op.attrs["is_test"] = True
    p._bump()
    return p


def create_paddle_predictor(config: AnalysisConfig) -> Predictor:
    """CreatePaddlePredictor (api/paddle_api.h:335) analog."""
    return Predictor(config)


def create_predictor_from_dir(model_dir: str) -> Predictor:
    """A Predictor from a ``save_inference_model`` directory with the
    defaults (on the card): the JAX package's entry for its native
    serving shim."""
    return Predictor(AnalysisConfig(model_dir=model_dir))
