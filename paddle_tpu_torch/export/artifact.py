"""Freeze and rehydrate deployable artifacts (save/load_artifact).

The port of paddle_tpu/export/artifact.py. ``save_artifact`` runs the
expensive half of the serving pipeline ONCE — verify, inference-rewrite,
the level-N TV-checked optimizer pipeline, param checksums, winner-table
slicing, memory prediction, AOT serialization — and writes the results
into one validated file (format.py, the JAX package's container byte
for byte: its ``params`` section is the same ``np.savez`` of the same
arrays). ``load_artifact`` is the cheap half: a file read plus mandatory
validation rehydrates a Predictor-ready bundle with ZERO optimize, ZERO
tune and ZERO plan-cache misses (plans are seeded); the cold-start
tests pin which telemetry counters a load may move.

Validation is mandatory, not advisory: config_key and TV-digest
mismatches, param checksum failures, truncated files and future format
versions are REFUSED with a typed :class:`ArtifactSkewError` and counted
(``paddle_export_artifact_skew_total``); optional sections degrade one
at a time to recompute, each degradation counted by (section, reason).
A skewed artifact is never silently served.

**The AOT section** is ``torch.export`` where the JAX package has
``jax.export``: one ``ExportedProgram`` per batch-size bucket of the
analysed step of the frozen program (``core.executor.analyze_block``,
the step the executor runs), with the feeds and the params as inputs —
the section carries no weights, the params section stays their one
source. Each is saved with ``torch.export.save`` into an inner zip
(``bucket_<n>.pt2``, and ``aot.json`` with the platform, ``cuda`` or
``cpu``, and on the card the device's name). The hand-written kernels
K1 and K4 are operators (``paddle_tpu_torch::flash_attention_fwd``,
``paddle_tpu_torch::layernorm_residual_fwd``), so the graph holds one
node per launch. A load runs ``torch.export.load(...).module()``; on the
card the Predictor's AOT runner captures a bucket's call as a CUDA graph
at its first request (after one eager call, which makes cuBLAS's
workspace and the allocator's blocks before the capture) and replays it
for every later request, with static feed buffers and the Predictor
executor's memory pool (core/cuda_graph.py).

The documented degradations stay, each recorded and counted: no
``batch_sizes`` (nothing to export), an impure program (state writes,
or an op that draws randomness when traced), ``aot=False``, an absent
section, and a section version from the future. **One departure from
the JAX package**, whose AOT is best effort (any exception degrades to
the plan path): an AOT section asked for on the card that fails to
export, or one that is present and fails to load for the card
(another platform's, another format's, or unreadable), raises
:class:`ArtifactError` naming the bucket and the op. It never serves
through the plan path in silence. On the CPU the JAX package's best
effort holds (recorded in ``manifest["aot_skipped"]`` at save, counted
as a degraded ``aot`` section at load).
"""

from __future__ import annotations

import io
import json
import re
import time
import zipfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..observe import trace as _tr
from .format import (ArtifactError, ArtifactSkewError, read_artifact,
                     read_section, sha256_hex, write_artifact,
                     write_section)

__all__ = ["save_artifact", "load_artifact", "LoadedArtifact"]

AOT_FORMAT = "torch.export"


# ------------------------------------------------------------- config
def _config_record() -> dict:
    """The portable optimization config the artifact was frozen under:
    the pass pipeline's full config_key (level + fold + quant + AMP
    knobs) and the kernel-tier master switch. Process-local kernel
    state (cache dir, table epoch) deliberately does NOT ride along —
    it could never match across hosts and the plan-cache key picks the
    live value up at seed time anyway."""
    from .. import kernels
    from ..core import passes

    return {"passes": list(passes.config_key()),
            "kernels_enabled": bool(kernels.kernels_enabled())}


def _check_config(manifest: dict) -> None:
    recorded = manifest.get("config_key")
    if recorded is None:
        return
    current = _config_record()
    if (list(recorded.get("passes") or []) != current["passes"]
            or bool(recorded.get("kernels_enabled"))
            != current["kernels_enabled"]):
        raise ArtifactSkewError(
            "config_key",
            "artifact was frozen under config %s but this process runs "
            "%s — a plan optimized under one config must never serve "
            "another (re-export, or align PADDLE_TPU_OPTIMIZE*/"
            "PADDLE_TPU_KERNELS)" % (recorded, current))


# -------------------------------------------------------------- save
def _host_array(v) -> Optional[np.ndarray]:
    """A state value as a host numpy array; None for a value that is no
    tensor (the RNG chain, a ``torch.Generator``)."""
    if isinstance(v, torch.Tensor):
        from ..core.executor import to_numpy

        return to_numpy(v)
    if isinstance(v, torch.Generator) or v is None:
        return None
    return np.asarray(v)


def _host_arrays(values) -> Dict[str, np.ndarray]:
    """``_host_array`` of each value, leaving out those that are none."""
    out = {}
    for n, v in values.items():
        a = _host_array(v)
        if a is not None:
            out[n] = a
    return out


def _resolve_source(obj, feed_names, fetch_names, params, scope):
    """Normalize the three accepted inputs to
    (program, feed_names, fetch_names, params, batch_major_fetches,
    exact_numerics, already_inference)."""
    from ..core.program import Program
    from ..imperative.jit import CapturedFunction
    from ..inference import Predictor

    if isinstance(obj, CapturedFunction):
        entry = obj._last_entry
        if entry is None:
            raise ArtifactError(
                "call %r once (to capture) before save_artifact"
                % obj.__name__)
        if entry.trainable:
            raise ArtifactError(
                "%r captured a backward/optimizer step; only inference "
                "captures can be frozen into a serving artifact"
                % obj.__name__)
        bm = [n for n, sl in zip(entry.fetch_names, entry.fetch_slice)
              if sl]
        return (entry.program, list(entry.feed_order),
                list(entry.fetch_names),
                _host_arrays({n: v.value for n, v in entry.state.items()}),
                bm, bool(getattr(entry.program, "exact_numerics", False)),
                False)
    if isinstance(obj, Predictor):
        p = _host_arrays({n: obj.scope.find_var(n)
                          for n in obj.scope.local_var_names()})
        return (obj.program, list(obj.feed_names), list(obj.fetch_names),
                p, [], bool(getattr(obj.program, "exact_numerics", False)),
                True)
    if isinstance(obj, Program):
        if feed_names is None or fetch_names is None:
            raise ArtifactError(
                "save_artifact(Program) needs feed_names= and "
                "fetch_names=")
        if params is None:
            if scope is None:
                raise ArtifactError(
                    "save_artifact(Program) needs params= (name -> "
                    "array) or scope= to read persistables from")
            params = {}
            for var in obj.list_vars():
                if var.persistable and scope.has_var(var.name):
                    params[var.name] = scope.find_var(var.name)
        return (obj, list(feed_names), list(fetch_names),
                _host_arrays(params), [],
                bool(getattr(obj, "exact_numerics", False)), False)
    raise ArtifactError(
        "save_artifact takes a Program, a CapturedFunction or a "
        "Predictor; got %r" % type(obj).__name__)


def _freeze_program(program, fetch_names, batch_major_fetches, params,
                    exact, already_inference):
    """Verify + inference-rewrite + (unless exact_numerics) run the
    LIVE-config optimizer pipeline with TV forced on. Returns
    (optimized_program, rewrite_log, pass_stats)."""
    from ..analysis import verify_program
    from ..core.passes import optimize_level, optimize_program
    from ..core.scope import Scope
    from ..inference import _rewrite_for_inference

    if not already_inference:
        program = _rewrite_for_inference(program)
        block = program.global_block()
        for n in batch_major_fetches:
            var = block.vars.get(n)
            if var is not None and var.shape:
                var.shape = (-1,) + tuple(var.shape[1:])
    pscope = Scope()
    for n, v in params.items():
        pscope.set_var(n, v)
    verify_program(program, fetch_list=list(fetch_names), scope=pscope,
                   raise_on_error=True, site="export")
    if exact or optimize_level() <= 0:
        # exact_numerics replays (and level-0 runs) execute the
        # UNOPTIMIZED sequence — freeze exactly what would run
        return program, [], []
    optimized, stats, mgr = optimize_program(
        program, fetch_list=list(fetch_names), scope=pscope,
        tv=True, return_manager=True)
    return optimized, mgr.rewrite_log, stats


def _params_blob(params: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{n: np.asarray(v) for n, v in params.items()})
    return buf.getvalue()


def _tuned_slice(program) -> dict:
    """The winner-table slice this program can consult: every entry
    under an op type the frozen program contains, plus the
    ``train_window`` schedule winners (keyed by program fingerprint —
    harmless to carry, they only match their program). A serving-only
    artifact (no program) carries the whole table: the engine's decode
    step is built load-side, so its op set is unknown here."""
    from ..kernels import tune

    if program is None:
        return {"version": tune.CACHE_VERSION,
                "entries": tune.export_entries()}
    ops = sorted({op.type for b in program.blocks for op in b.ops})
    prefixes = ["%s|" % t for t in ops] + ["train_window|"]
    return {"version": tune.CACHE_VERSION,
            "entries": tune.export_entries(keys=prefixes)}


def _memory_record(program, fetch_names, batch_sizes) -> Optional[dict]:
    try:
        from ..analysis.memory import MemoryAnalysis

        ma = MemoryAnalysis(program, list(fetch_names), site="export")
        poly = ma.peak_poly(max(list(batch_sizes) or [1]))
        return {"peak_poly": {str(d): c for d, c in poly.terms.items()},
                "peak_poly_text": poly.describe(),
                "predicted_bytes": {str(b): int(ma.peak_bytes(b))
                                    for b in (batch_sizes or (1,))}}
    except Exception:
        return None


def _zero_feed(block, feed_names, batch_size):
    """Zero host feeds of one bucket, at the program's declared dtypes."""
    feed = {}
    for n in feed_names:
        var = block.var(n)
        shape = [batch_size if (s is None or s < 0) else int(s)
                 for s in (var.shape or ())]
        feed[n] = np.zeros(shape, dtype=var.dtype)
    return feed


class _ExportedStep(torch.nn.Module):
    """The analysed step as a module of (feeds..., params...) ->
    fetches: what ``torch.export`` traces for one bucket. No RNG chain
    is passed: an op that draws randomness raises while tracing."""

    def __init__(self, step, feed_names, param_names, device):
        super().__init__()
        self._step = step
        self._feed_names = list(feed_names)
        self._param_names = list(param_names)
        self._device = device

    def forward(self, *args):
        n = len(self._feed_names)
        feeds = dict(zip(self._feed_names, args[:n]))
        state = dict(zip(self._param_names, args[n:]))
        fetches, _ = self._step(feeds, state, None, self._device)
        return tuple(fetches)


_LOWERING = re.compile(r"while lowering op '([^']+)'")


def _failing_op(e: BaseException) -> str:
    """The op type a lowering error names (``core.lowering.lower_ops``
    prefixes it), or ``"?"``."""
    while e is not None:
        m = _LOWERING.search(str(e))
        if m:
            return m.group(1)
        e = e.__cause__ or e.__context__
    return "?"


def _draws_randomness(e: BaseException) -> bool:
    """Whether ``e`` came from an op asking the (absent) RNG chain for a
    stream: the traced step is not pure."""
    while e is not None:
        if "requested RNG in a pure context" in str(e):
            return True
        e = e.__cause__ or e.__context__
    return False


def _device_name(device: torch.device) -> Optional[str]:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else None)


def _aot_blob(program, feed_names, fetch_names, params, batch_sizes,
              manifest, device, strict) -> Optional[bytes]:
    """``torch.export`` one program per batch-size bucket on ``device``
    into an inner zip (aot.json + bucket_<n>.pt2). Returns None — the
    counted sections-absent degradation — when no bucket is asked for or
    the program is impure, and, unless ``strict`` (the card), when
    export fails; the manifest records why. A ``strict`` export that
    fails raises ``ArtifactError`` naming the bucket and the op."""
    from ..core.executor import analyze_block, feed_to_device
    from ..core.scope import Scope

    if not batch_sizes:
        manifest["aot_skipped"] = "no batch_sizes requested"
        return None
    scope = Scope()
    for n, v in params.items():
        scope.set_var(n, v)
    block = program.global_block()
    platform = device.type
    buckets: List[dict] = []
    inner = io.BytesIO()
    with zipfile.ZipFile(inner, "w", zipfile.ZIP_STORED) as zf:
        for bs in sorted(set(int(b) for b in batch_sizes)):
            feed = _zero_feed(block, feed_names, bs)
            (f_names, o_names, const_state, mut_state, pure_written,
             _, step) = analyze_block(program, sorted(feed),
                                      list(fetch_names), scope)
            if mut_state or pure_written:
                manifest["aot_skipped"] = (
                    "program is not pure (state writes %s/%s)"
                    % (mut_state, pure_written))
                return None
            args = [feed_to_device(n, feed[n], block.vars.get(n), device)
                    for n in f_names]
            args += [torch.from_numpy(np.asarray(params[n])).to(device)
                     for n in const_state]
            module = _ExportedStep(step, f_names, const_state, device)
            try:
                with torch.no_grad():
                    exported = torch.export.export(module, tuple(args),
                                                   strict=False)
            except Exception as e:
                if _draws_randomness(e):
                    manifest["aot_skipped"] = (
                        "program is not pure (op %r draws randomness)"
                        % _failing_op(e))
                    return None
                why = ("bucket %d does not export at op %r (%s: %s)"
                       % (bs, _failing_op(e), type(e).__name__, e))
                if strict:
                    raise ArtifactError("AOT section: " + why) from e
                manifest["aot_skipped"] = why
                return None
            # the example inputs hold the params: the section keeps no
            # weights (the params section is their one source)
            exported.example_inputs = None
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            zf.writestr("bucket_%d.pt2" % bs, buf.getvalue())
            buckets.append({
                "batch_size": bs,
                "feed_names": list(f_names),
                "feed_dtypes": [str(a.dtype) for a in args[:len(f_names)]],
                "param_names": list(const_state),
                "out_names": list(o_names),
            })
        zf.writestr("aot.json", json.dumps(
            {"format": AOT_FORMAT, "platform": platform,
             "device_name": _device_name(device),
             "torch": torch.__version__, "buckets": buckets},
            sort_keys=True))
    return inner.getvalue()


def save_artifact(obj, path: str, *,
                  feed_names: Optional[Sequence[str]] = None,
                  fetch_names: Optional[Sequence[str]] = None,
                  params: Optional[Dict[str, Any]] = None,
                  scope=None,
                  batch_sizes: Sequence[int] = (),
                  aot: Optional[bool] = None,
                  serving: Optional[dict] = None,
                  name: Optional[str] = None,
                  place=None) -> str:
    """Freeze ``obj`` — a ``Program`` (+ ``feed_names``/``fetch_names``
    and ``params`` or ``scope``), a ``CapturedFunction`` (last capture)
    or a ``Predictor`` — into one deployable artifact file at ``path``.

    What gets frozen: the verified + live-config-optimized program
    (TV forced on; ``exact_numerics`` captures freeze the unoptimized
    sequence, exactly what would run), per-var-checksummed params, the
    tuned-kernel + train_window winner slice the program can consult,
    the predicted peak-memory polynomial, the full config_key, the TV
    rewrite-log digest, and — for each ``batch_sizes`` bucket, unless
    ``aot=False`` or ``PADDLE_TPU_EXPORT_AOT=0`` — a ``torch.export``
    program exported on ``place`` (default the card; ``CPUPlace()`` for
    the CPU). ``serving=`` attaches a ``DecodeEngine`` construction
    record (``cfg``/``b_max``/``max_len``) for
    ``DecodeEngine.from_artifact`` and ``ReplicaRouter.roll``.
    ``obj=None`` with ``params=`` and ``serving=`` writes a serving-only
    artifact — no program section, the engine rebuilds its decode step
    from ``cfg`` but re-tunes and re-checksums nothing. Returns
    ``path``."""
    import os as _os

    from ..observe.families import ARTIFACT_SAVE_SECONDS, ARTIFACT_SAVES

    t0 = time.perf_counter()
    with _tr.trace_span("export.save", path=path):
        if obj is None:
            if params is None or serving is None:
                raise ArtifactError(
                    "save_artifact(None) is the serving-only form: it "
                    "needs params= and serving={'cfg': ...}")
            program, feeds, fetches = None, [], []
            pvals = _host_arrays(params)
            rewrite_log, pass_stats, exact = None, [], False
        else:
            (program, feeds, fetches, pvals, bm, exact,
             already_inf) = _resolve_source(obj, feed_names, fetch_names,
                                            params, scope)
            program, rewrite_log, pass_stats = _freeze_program(
                program, fetches, bm, pvals, exact, already_inf)
        from ..core.passes import optimize_level

        manifest: dict = {
            "name": name or getattr(obj, "__name__", None)
            or "artifact",
            "feed_names": feeds,
            "fetch_names": fetches,
            "batch_sizes": sorted(set(int(b) for b in batch_sizes)),
            "exact_numerics": exact,
            "optimize_level": 0 if exact else optimize_level(),
            "config_key": _config_record(),
            "pass_stats": [{k: v for k, v in row.items()
                            if k in ("pass", "ops_before", "ops_after")}
                           for row in pass_stats],
            "params": {
                n: {"sha256": sha256_hex(np.asarray(v).tobytes()),
                    "dtype": str(np.asarray(v).dtype),
                    "shape": list(np.asarray(v).shape)}
                for n, v in pvals.items()},
        }
        blobs: Dict[str, bytes] = {}
        if program is not None:
            write_section(blobs, manifest, "program",
                          json.dumps(program.to_dict(),
                                     sort_keys=True).encode())
        write_section(blobs, manifest, "params", _params_blob(pvals))
        write_section(blobs, manifest, "tuned_kernels",
                      json.dumps(_tuned_slice(program),
                                 sort_keys=True).encode())
        if rewrite_log is not None:
            log_blob = json.dumps(rewrite_log, sort_keys=True,
                                  default=repr).encode()
            manifest["tv_digest"] = sha256_hex(log_blob)
            write_section(blobs, manifest, "rewrite_log", log_blob)
        mem = (None if program is None else _memory_record(
            program, fetches, manifest["batch_sizes"]))
        if mem is not None:
            manifest["predicted_bytes"] = mem["predicted_bytes"]
            write_section(blobs, manifest, "memory",
                          json.dumps(mem, sort_keys=True).encode())
        want_aot = (aot if aot is not None else
                    _os.environ.get("PADDLE_TPU_EXPORT_AOT", "1") != "0")
        if program is not None and want_aot:
            from ..core.place import default_place, require_device

            device = require_device((place if place is not None
                                     else default_place()).torch_device())
            ab = _aot_blob(program, feeds, fetches, pvals,
                           manifest["batch_sizes"], manifest, device,
                           strict=device.type == "cuda")
            if ab is not None:
                write_section(blobs, manifest, "aot", ab)
        elif program is not None and batch_sizes:
            manifest["aot_skipped"] = "disabled (aot=False / " \
                "PADDLE_TPU_EXPORT_AOT=0)"
        if serving is not None:
            if "cfg" not in serving:
                raise ArtifactError(
                    "serving= record needs at least a 'cfg' dict "
                    "(DecodeEngine model config)")
            write_section(blobs, manifest, "serving",
                          json.dumps(serving, sort_keys=True).encode())
        write_artifact(path, manifest, blobs)
    ARTIFACT_SAVES.inc()
    ARTIFACT_SAVE_SECONDS.observe(time.perf_counter() - t0)
    return path


# -------------------------------------------------------------- load
class _AotProgram:
    """One bucket's loaded ``torch.export`` program and its signature."""

    def __init__(self, module, meta):
        self.module = module
        self.batch_size = int(meta["batch_size"])
        self.feed_names = list(meta["feed_names"])
        self.feed_dtypes = list(meta["feed_dtypes"])
        self.param_names = list(meta["param_names"])
        self.out_names = list(meta["out_names"])


class _AotRunner:
    """A bucket's loaded program bound to a Predictor: called with a
    routed feed (numpy or tensors), returns the fetches as numpy.

    Feeds take the executor's conversion (``feed_to_device``: int64
    narrowed to int32 with its range check, outside the exported
    graph); the params are the Predictor scope's tensors. On the CPU
    each call runs the module. On the card the first call runs it once,
    then captures it as a CUDA graph (``StepGraph``: static feed
    buffers, the Predictor executor's pool and capture stream), and
    every call replays the graph; ``capture_seconds`` holds the
    capture's host time."""

    def __init__(self, prog: _AotProgram, block, scope, exe):
        self.prog = prog
        self.feed_names = prog.feed_names
        self.out_names = prog.out_names
        self._vars = block.vars.get
        self._scope = scope
        self._exe = exe
        self.device = exe.device
        self.graph = None
        self.capture_seconds: Optional[float] = None

    def _step(self, feeds, state, rng, device, graph=None):
        outs = self.prog.module(*([feeds[n] for n in self.feed_names]
                                  + [state[n] for n in
                                     self.prog.param_names]))
        return list(outs), {}

    def _state(self):
        from ..core.executor import _require

        return {n: _require(self._scope, n) for n in self.prog.param_names}

    def run(self, feed) -> List[torch.Tensor]:
        """The fetched tensors of one call (on the card, the graph's
        outputs: valid until the next replay of the executor's graphs)."""
        from ..core.cuda_graph import StepGraph, StepTrace
        from ..core.executor import feed_to_device

        feeds = {n: feed_to_device(n, feed[n], self._vars(n), self.device)
                 for n in self.feed_names}
        state = self._state()
        with torch.no_grad():
            if self.device.type != "cuda":
                return self._step(feeds, state, None, self.device)[0]
            if self.graph is None:
                self._step(feeds, state, None, self.device)
                exe = self._exe
                if exe._pool is None:
                    exe._pool = torch.cuda.graph_pool_handle()
                if exe._stream is None:
                    exe._stream = torch.cuda.Stream(self.device)
                self.graph = StepGraph(self._step, feeds, state, [],
                                       StepTrace(), self.device,
                                       self._scope, exe._pool, exe._stream)
                self.capture_seconds = self.graph.seconds
            self.graph.replay(feeds, None)
            return self.graph.fetches

    def __call__(self, feed: Dict[str, Any]) -> List[np.ndarray]:
        from ..core.executor import to_numpy

        return [to_numpy(v) for v in self.run(feed)]

    def release(self) -> None:
        if self.graph is not None:
            self.graph.release()
            self.graph = None


class LoadedArtifact:
    """A validated, rehydrated artifact: the frozen program + params +
    winner slice are already installed process-side; ``predictor()``
    hands back a serving-ready Predictor whose plan cache is seeded
    (zero misses for covered signatures) and whose bucket runs ride the
    AOT section when present. ``place`` is where it serves (default the
    card)."""

    def __init__(self, path, manifest, place=None):
        from ..core.place import default_place

        self.path = path
        self.manifest = manifest
        self.place = place if place is not None else default_place()
        self.program = None
        self.feed_names: List[str] = list(manifest.get("feed_names")
                                          or [])
        self.fetch_names: List[str] = list(manifest.get("fetch_names")
                                           or [])
        self.params: Dict[str, np.ndarray] = {}
        self.tuned_imported = 0
        self.memory: Optional[dict] = None
        self.rewrite_log: Optional[list] = None
        self.aot: Dict[int, _AotProgram] = {}
        self.aot_meta: Optional[dict] = None
        self.serving: Optional[dict] = None
        self.degraded: List[tuple] = []

    # ------------------------------------------------------- queries
    @property
    def batch_sizes(self) -> List[int]:
        return list(self.manifest.get("batch_sizes") or [])

    def predicted_bytes(self, batch_size: int) -> Optional[int]:
        """Evaluate the frozen peak-memory polynomial at
        ``batch_size`` (None when the memory section degraded)."""
        if not self.memory:
            return None
        b = max(1, int(batch_size))
        return int(round(sum(float(c) * (b ** int(d)) for d, c in
                             (self.memory.get("peak_poly")
                              or {}).items())))

    # ------------------------------------------------------ serving
    def predictor(self, warmup_batch_sizes: Optional[Sequence[int]]
                  = None):
        """A Predictor over the frozen program on the artifact's place:
        ``pre_optimized`` (the executor will not re-run the pass
        pipeline), plan-cache seeded per bucket (first runs are HITS,
        counted in ``paddle_export_plans_seeded_total``), AOT runners
        attached when the section survived. Default buckets are the
        artifact's recorded ``batch_sizes``."""
        from ..inference import Predictor
        from ..observe.families import ARTIFACT_PLANS_SEEDED

        if self.program is None:
            raise ArtifactError(
                "artifact %r carries no program section (serving-only "
                "artifact?) — predictor() needs one" % self.path)
        buckets = (self.batch_sizes if warmup_batch_sizes is None
                   else sorted(set(int(b) for b in warmup_batch_sizes)))
        device = self.place.torch_device()
        pred = Predictor.from_program(
            self.program, self.feed_names, self.fetch_names,
            {n: torch.from_numpy(np.asarray(v)).to(device)
             for n, v in self.params.items()},
            pre_optimized=True, place=self.place)
        pred._buckets = list(buckets)
        block = self.program.global_block()
        for bs in buckets:
            feed = _zero_feed(block, self.feed_names, bs)
            if pred._exe.seed_plan(self.program, feed,
                                   self.fetch_names, scope=pred.scope):
                ARTIFACT_PLANS_SEEDED.inc()
        if self.aot:
            pred._aot = {bs: _AotRunner(p, block, pred.scope, pred._exe)
                         for bs, p in self.aot.items()}
        return pred


def _load_params(manifest, blob, path):
    """Parse + per-var-validate the params section: every recorded var
    must be present with the recorded dtype/shape and sha256 — a
    single flipped byte refuses the artifact (``param_checksum``)."""
    try:
        data = np.load(io.BytesIO(blob), allow_pickle=False)
        arrays = {n: data[n] for n in data.files}
    except Exception as e:
        raise ArtifactSkewError(
            "param_checksum",
            "artifact %r params section is unreadable (%s: %s)"
            % (path, type(e).__name__, e))
    out = {}
    for n, rec in (manifest.get("params") or {}).items():
        arr = arrays.get(n)
        if arr is None:
            raise ArtifactSkewError(
                "param_checksum",
                "artifact %r params section lacks recorded var %r"
                % (path, n))
        if sha256_hex(arr.tobytes()) != rec.get("sha256") \
                or str(arr.dtype) != rec.get("dtype") \
                or list(arr.shape) != list(rec.get("shape") or []):
            raise ArtifactSkewError(
                "param_checksum",
                "artifact %r param %r fails its recorded checksum/"
                "dtype/shape — corrupted or tampered weights are "
                "never served" % (path, n))
        out[n] = arr
    return out


def load_artifact(path: str, place=None) -> LoadedArtifact:
    """Validate + rehydrate an artifact (the cheap half — a file read)
    to serve on ``place`` (default the card).

    The validation ladder, in order, all mandatory: container + format
    version (``corrupt``/``future_version``), recorded config_key vs
    the running process (``config_key``), per-section sha256
    (``section_checksum``), the TV rewrite-log digest (``tv_digest``),
    per-var param checksums (``param_checksum``). Any failure raises
    :class:`ArtifactSkewError`, counted by reason — never silently
    served. Optional sections (tuned_kernels / memory / rewrite_log /
    aot) degrade individually to recompute, counted by (section,
    reason) in ``paddle_export_artifact_degraded_total``; but an AOT
    section that does not load for the card raises (module
    docstring)."""
    from ..observe.families import (ARTIFACT_DEGRADED, ARTIFACT_LOADS,
                                    ARTIFACT_SKEW)

    t0 = time.perf_counter()
    try:
        with _tr.trace_span("export.load", path=path):
            manifest, zf = read_artifact(path)
            try:
                art = _load_validated(path, manifest, zf, place)
            finally:
                zf.close()
    except ArtifactSkewError as e:
        ARTIFACT_SKEW.labels(reason=e.reason).inc()
        ARTIFACT_LOADS.labels(
            outcome="corrupt" if e.reason == "corrupt" else "skew").inc()
        raise
    for section, reason in art.degraded:
        ARTIFACT_DEGRADED.labels(section=section, reason=reason).inc()
    ARTIFACT_LOADS.labels(outcome="ok").inc()
    from ..observe.families import ARTIFACT_LOAD_SECONDS

    ARTIFACT_LOAD_SECONDS.observe(time.perf_counter() - t0)
    return art


def _load_aot(art: LoadedArtifact, blob: bytes) -> None:
    """Load the AOT section's programs for ``art.place``. A section of
    another format or platform, or one that does not load, raises
    ``ArtifactError`` for the card and degrades for the CPU, counted
    under the JAX package's reason for a section that does not
    deserialize, ``("aot", "jax")``."""
    device = art.place.torch_device()
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as azf:
            meta = json.loads(azf.read("aot.json"))
            art.aot_meta = meta
            if meta.get("format") != AOT_FORMAT or \
                    meta.get("platform") != device.type:
                raise ArtifactError(
                    "AOT section of artifact %r holds %s programs for "
                    "platform %r; this process serves on %s"
                    % (art.path, meta.get("format", "jax.export"),
                       meta.get("platform"), device.type))
            for b in meta["buckets"]:
                bs = int(b["batch_size"])
                try:
                    ep = torch.export.load(io.BytesIO(
                        azf.read("bucket_%d.pt2" % bs)))
                    art.aot[bs] = _AotProgram(ep.module(), b)
                except Exception as e:
                    raise ArtifactError(
                        "AOT section of artifact %r: bucket %d does not "
                        "load (%s: %s)" % (art.path, bs, type(e).__name__,
                                           e)) from e
    except Exception as e:
        if device.type == "cuda":
            if isinstance(e, ArtifactError):
                raise
            raise ArtifactError("AOT section of artifact %r does not load "
                                "(%s: %s)" % (art.path, type(e).__name__,
                                              e)) from e
        art.aot = {}
        art.degraded.append(("aot", "jax"))


def _load_validated(path, manifest, zf, place=None) -> LoadedArtifact:
    from ..io import _program_from_dict
    from ..kernels import tune

    _check_config(manifest)
    art = LoadedArtifact(path, manifest, place)
    versions = manifest.get("section_versions") or {}

    # --- program (mandatory when listed; version skew refuses: there
    # is nothing to serve if the program schema is unknown)
    prog_blob = read_section(zf, manifest, "program")
    if prog_blob is not None:
        if versions.get("program", 1) > 1:
            raise ArtifactSkewError(
                "future_version",
                "artifact %r program section is schema version %s; "
                "this runtime reads <= 1" % (path,
                                             versions.get("program")))
        try:
            art.program = _program_from_dict(json.loads(prog_blob))
        except Exception as e:
            raise ArtifactSkewError(
                "corrupt", "artifact %r program section does not "
                "parse (%s: %s)" % (path, type(e).__name__, e))
        art.program.exact_numerics = bool(
            manifest.get("exact_numerics", False))
        # the executor trusts the freeze: _prepare skips the pass
        # pipeline for this program (it already ran, TV-checked, at
        # save time — that is the zero-optimize contract)
        art.program._pre_optimized = True

    # --- TV rewrite-log digest (mandatory when a program rides along)
    log_blob = read_section(zf, manifest, "rewrite_log")
    if log_blob is not None:
        if manifest.get("tv_digest") != sha256_hex(log_blob):
            raise ArtifactSkewError(
                "tv_digest",
                "artifact %r rewrite-log digest mismatch: the frozen "
                "program's optimization provenance cannot be trusted"
                % path)
        art.rewrite_log = json.loads(log_blob)
    elif art.program is not None:
        art.degraded.append(("rewrite_log", "absent"))

    # --- params (mandatory: weights are the artifact's payload)
    par_blob = read_section(zf, manifest, "params")
    if par_blob is None:
        raise ArtifactError(
            "artifact %r carries no params section" % path)
    art.params = _load_params(manifest, par_blob, path)

    # --- tuned winner slice (optional: absent/version-skewed slices
    # degrade to re-tune, counted)
    tk_blob = read_section(zf, manifest, "tuned_kernels")
    if tk_blob is None:
        art.degraded.append(("tuned_kernels", "absent"))
    else:
        rec = json.loads(tk_blob)
        if rec.get("version") != tune.CACHE_VERSION:
            art.degraded.append(("tuned_kernels", "version"))
        else:
            art.tuned_imported = tune.import_entries(
                rec.get("entries") or {})

    # --- memory prediction (optional)
    mem_blob = read_section(zf, manifest, "memory")
    if mem_blob is None:
        if art.program is not None:
            art.degraded.append(("memory", "absent"))
    else:
        art.memory = json.loads(mem_blob)

    # --- AOT programs (optional; a section that does not load for the
    # card raises, see the module docstring)
    aot_blob = read_section(zf, manifest, "aot")
    if aot_blob is None:
        if art.program is not None:
            art.degraded.append(("aot", "absent"))
    elif versions.get("aot", 1) > 1:
        art.degraded.append(("aot", "version"))
    else:
        _load_aot(art, aot_blob)

    # --- serving record (optional; engines need it, predictors don't)
    srv_blob = read_section(zf, manifest, "serving")
    if srv_blob is not None:
        art.serving = json.loads(srv_blob)
    return art
