"""Roofline cost engine: the fifth analysis engine.

The port of paddle_tpu/analysis/cost.py. Shapes, dataflow hazards,
value ranges and bytes at rest have their engines; this one models
**time**: per-op FLOPs and bytes moved (``analysis/cost_rules.py``, a
copy of the JAX package's table) over the shared
:class:`~paddle_tpu_torch.analysis.dataflow.Dataflow` facts, composed
into a roofline estimate

    predicted_seconds = sum_op max(flops_op / peak_flops(op),
                                   bytes_op / peak_bandwidth)
                        + n_ops * op_overhead + call_overhead / K

so a tuning decision can be RANKED before anything is measured
(``kernels/autotune.py`` is the one global autotuner built on it).

Both FLOPs and bytes are :class:`~paddle_tpu_torch.analysis.memory.BytesPoly`
polynomials of the batch dim, so ONE analysis prices every batch size
and every window length K (the per-call host overhead amortizes by K).

The device model differs from the JAX package's in three ways:

* **The card's peaks come from a table** (``_CUDA_PEAKS``, NVIDIA's H100
  SXM5 datasheet): f32 outside the tensor cores, TF32 and bf16 / f16 on
  them (dense), and HBM3's rate. Any other card, and the CPU, is
  calibrated.
* **The compute peak follows the dtype an op's product runs in** on the
  card (``CostAnalysis.product_dtype``): bf16 for the ops ``core/amp.py``
  casts when the program is under AMP, TF32 for the matmul-family
  products while ``torch.backends.cuda.matmul.allow_tf32`` is on, f32
  otherwise (the H100 runs f32 15x slower than bf16, so one peak for
  every op would misprice one of them by that much).
  ``predicted_mfu`` divides by the peak of the program's products.
* **Calibration probes through the port itself**: a GEMM and a
  streaming add for the peaks (the CPU and an unknown card); a 3 -> 32
  ``F.conv2d`` under the port's conv flags for the conv class's ceiling;
  one ``Executor.run`` of a replayed one-op plan for the per-call
  overhead, and a replayed training step of tiny residual conv and fc
  blocks for the per-op overhead (what a Program's op costs beyond its
  FLOPs and bytes: its kernels' launches and gaps, a grad op's several
  kernels; ``overhead_probe_programs``). On a table card the
  peaks come from the table; the conv probe and the two overheads
  persist in ``device_model.json`` under the kernel tuner's cache
  directory (``kernels/tune.py`` ``cache_dir``), so a process pays the
  probes once. On the card a probe that fails raises; on the CPU a
  failure degrades to ``source="default"`` (the JAX package's
  never-raises contract).

Per-field env overrides (``PADDLE_TPU_PEAK_TFLOPS`` /
``PADDLE_TPU_PEAK_GBPS`` / ``PADDLE_TPU_OP_OVERHEAD_US`` /
``PADDLE_TPU_CALL_OVERHEAD_US``) pin the model exactly, every dtype's
peak included: deterministic tests set all four and never probe.

The estimate cannot see kernel fusion, overlap or the card's clocks: it
brackets the step coarsely. ``chip_smoke.py`` phase 18 holds the
predicted step within ``ZOO_COST_GATE_FACTOR`` (4x) of the measured
replayed step on >= 9/11 zoo train programs on the card.

``PADDLE_TPU_COST_MODEL=0`` disarms every consumer (the autotuner
measures everything) and no ``paddle_cost_*`` family moves.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..core.program import Program
from .cost_rules import COST_RULES, GRAD_FLOPS_FACTOR, ZERO_COST, CostContext
from .dataflow import Dataflow
from .memory import BytesPoly, dtype_bytes

__all__ = ["CostAnalysis", "DeviceModel", "ZOO_COST_GATE_FACTOR",
           "cost_model_enabled", "predict_step_seconds"]

# the stated factor of the model-zoo ground-truth gate: predicted step
# seconds must sit within [measured/F, measured*F] on >= 9/11 zoo train
# programs (the JAX package's gate, held on the card by chip_smoke.py)
ZOO_COST_GATE_FACTOR = 4.0

# 2: the per-op overhead is probed by the residual layer-mix step
DEVICE_MODEL_VERSION = 2
DEVICE_MODEL_FILE = "device_model.json"

# the card's peak FLOP/s by the dtype its products run in, and its HBM
# rate, by device-name substring (lowercase). Source: NVIDIA H100 Tensor
# Core GPU datasheet, H100 SXM column: FP32 66.9 TFLOPS; TF32 Tensor Core
# 494.7 and BF16 / FP16 Tensor Core 989.4 TFLOPS dense (the datasheet's
# 989 / 1979 are with sparsity); GPU memory bandwidth 3.35 TB/s
_CUDA_PEAKS = {
    "h100": ({"float32": 66.9e12, "tf32": 494.7e12,
              "bfloat16": 989.4e12, "float16": 989.4e12}, 3.35e12),
}
# the products whose f32 form runs in TF32 when torch allows it (torch
# matmuls; the port's convolutions run under ops.nn._conv_flags, TF32
# off, and the flash kernels compute f32 with FMAs)
_TF32_OPS = frozenset({"mul", "matmul", "matmul_v2", "bmm", "dot"})

# static defaults for a model nothing resolved (CPU probe failure only)
_DEFAULT_OP_OVERHEAD = 1e-6
_DEFAULT_CALL_OVERHEAD = 300e-6
# the overhead probes' sizes: the blocks of each layer family, their
# width (channels, features, image side and sequence length), the batch,
# and the runs each probe takes the median of
_PROBE_DEPTH = 6
_PROBE_WIDTH = 8
_PROBE_BATCH = 8
_PROBE_RUNS = 10

_MODEL_LOCK = threading.RLock()
_MODEL_CACHE: Dict[tuple, "DeviceModel"] = {}


def _best_seconds(dev, fn, repeats: int = 5, warmup: int = 3) -> float:
    """The best of ``repeats`` timed calls of ``fn`` on ``dev`` (each
    waited for), after ``warmup`` calls (library setup, a thread pool's
    start)."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn()
    sync()
    t = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        t.append(time.perf_counter() - t0)
    return max(min(t), 1e-9)


def cost_model_enabled() -> bool:
    """``PADDLE_TPU_COST_MODEL=0`` disarms every cost-model consumer:
    the unified autotuner degrades to measure-everything and no
    ``paddle_cost_*`` family moves (default ON)."""
    return os.environ.get("PADDLE_TPU_COST_MODEL", "1") != "0"


def _env_float(name: str, scale: float) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        val = float(raw) * scale
    except ValueError:
        raise ValueError("%s must be a number; got %r"
                         % (name, raw)) from None
    if val <= 0:
        raise ValueError("%s must be positive, got %r" % (name, raw))
    return val


def _on_card(kind: str) -> bool:
    return kind.startswith("cuda:")


class DeviceModel:
    """The numbers the roofline needs, with provenance.

    ``peak_flops`` (f32 FLOP/s) and ``peak_bandwidth`` (bytes/s) divide
    the per-op work; ``dtype_peaks`` holds the peak of each dtype a
    product can run in (``"float32"``, ``"tf32"``, ``"bfloat16"``,
    ``"float16"``; ``peak_for``), all ``peak_flops`` on a calibrated
    device; ``conv_peak_flops`` is the conv family's f32 ceiling (the
    3 -> 32 probe's, at most ``peak_flops``);
    ``op_overhead`` (seconds per op inside one step) floors programs of
    tiny ops; ``call_overhead`` (seconds per ``Executor.run``: feeds,
    dispatch, fetches) is what a train window of length K divides by
    K. Resolution per field: env override > persisted calibration >
    peak table + probed overheads > one-shot probe (persisted) > static
    defaults (the CPU only)."""

    __slots__ = ("kind", "peak_flops", "peak_bandwidth", "op_overhead",
                 "call_overhead", "conv_peak_flops", "dtype_peaks",
                 "source")

    def __init__(self, kind: str, peak_flops: float, peak_bandwidth: float,
                 op_overhead: float = _DEFAULT_OP_OVERHEAD,
                 call_overhead: float = _DEFAULT_CALL_OVERHEAD,
                 conv_peak_flops: Optional[float] = None,
                 source: str = "explicit",
                 dtype_peaks: Optional[Dict[str, float]] = None):
        self.kind = kind
        self.peak_flops = float(peak_flops)
        self.peak_bandwidth = float(peak_bandwidth)
        self.op_overhead = float(op_overhead)
        self.call_overhead = float(call_overhead)
        self.conv_peak_flops = float(
            conv_peak_flops if conv_peak_flops else peak_flops)
        self.dtype_peaks = {k: float(v)
                            for k, v in (dtype_peaks or {}).items()}
        self.dtype_peaks.setdefault("float32", self.peak_flops)
        self.source = source

    def peak_for(self, dtype: str) -> float:
        """The compute peak of a product run in ``dtype``."""
        return self.dtype_peaks.get(dtype, self.peak_flops)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "peak_flops": self.peak_flops,
                "peak_bandwidth": self.peak_bandwidth,
                "op_overhead": self.op_overhead,
                "call_overhead": self.call_overhead,
                "conv_peak_flops": self.conv_peak_flops,
                "dtype_peaks": dict(self.dtype_peaks),
                "source": self.source}

    def __repr__(self):
        return ("DeviceModel(%s: %.3g FLOP/s f32 (conv %.3g; %s), %.3g "
                "B/s, op %.3gs, call %.3gs, %s)"
                % (self.kind, self.peak_flops, self.conv_peak_flops,
                   ", ".join("%s %.3g" % kv for kv in
                             sorted(self.dtype_peaks.items())),
                   self.peak_bandwidth, self.op_overhead,
                   self.call_overhead, self.source))

    # ------------------------------------------------------- resolution
    @classmethod
    def current(cls) -> "DeviceModel":
        """The model for the current device, memoized per (device,
        env-override) key. On the CPU it never raises (a probe failure
        degrades to the static defaults, source='default'); on the card
        a failed probe raises."""
        overrides = (
            _env_float("PADDLE_TPU_PEAK_TFLOPS", 1e12),
            _env_float("PADDLE_TPU_PEAK_GBPS", 1e9),
            _env_float("PADDLE_TPU_OP_OVERHEAD_US", 1e-6),
            _env_float("PADDLE_TPU_CALL_OVERHEAD_US", 1e-6),
        )
        kind = cls._device_kind()
        key = (kind,) + overrides
        with _MODEL_LOCK:
            got = _MODEL_CACHE.get(key)
            if got is not None:
                return got
        model = cls._resolve(kind, overrides)
        with _MODEL_LOCK:
            _MODEL_CACHE[key] = model
        return model

    @staticmethod
    def _device_kind() -> str:
        """``"cuda:<device name>"`` where a card is visible, else
        ``"cpu:cpu"``."""
        import torch

        if torch.cuda.is_available():
            return "cuda:%s" % torch.cuda.get_device_name()
        return "cpu:cpu"

    @staticmethod
    def _table(kind: str):
        low = kind.lower()
        if not _on_card(kind):
            return None
        for key, val in _CUDA_PEAKS.items():
            if key in low:
                return val
        return None

    @classmethod
    def _resolve(cls, kind: str, overrides) -> "DeviceModel":
        flops_env, bw_env, op_env, call_env = overrides
        if flops_env and bw_env and op_env and call_env:
            return cls(kind, flops_env, bw_env, op_env, call_env,
                       source="env")
        base = cls._load_calibrated(kind)
        table = cls._table(kind)
        if base is None and table is not None:
            peaks, bw = table
            if op_env and call_env:
                op, call = op_env, call_env  # nothing left to probe
                conv = None if flops_env else cls._probe_conv(kind)
            else:
                op, call = cls._probe_overheads(kind)
                conv = cls._probe_conv(kind)
            base = cls(kind, peaks["float32"], bw, op, call,
                       conv_peak_flops=conv and min(conv, peaks["float32"]),
                       dtype_peaks=peaks, source="table")
            if not (op_env and call_env):
                base.persist()
        if base is None:
            base = cls._calibrate(kind)
        if base is None:
            base = cls(kind, 50e9, 10e9, source="default")
        if flops_env or bw_env or op_env or call_env:
            # an env FLOP peak pins every dtype's peak and the conv-class
            # ceiling too: the override pins the model, it doesn't mix
            # with table or probes
            base = cls(kind, flops_env or base.peak_flops,
                       bw_env or base.peak_bandwidth,
                       op_env or base.op_overhead,
                       call_env or base.call_overhead,
                       conv_peak_flops=(None if flops_env
                                        else base.conv_peak_flops),
                       dtype_peaks=(None if flops_env
                                    else base.dtype_peaks),
                       source="env")
        return base

    # ------------------------------------------------------ persistence
    @staticmethod
    def _path() -> Optional[str]:
        from ..kernels import tune

        d = tune.cache_dir()
        return os.path.join(d, DEVICE_MODEL_FILE) if d else None

    @classmethod
    def _load_calibrated(cls, kind: str) -> Optional["DeviceModel"]:
        path = cls._path()
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                data = json.load(f)
        except (ValueError, OSError):
            return None
        if not isinstance(data, dict) \
                or data.get("version") != DEVICE_MODEL_VERSION:
            return None
        entry = (data.get("models") or {}).get(kind)
        if not isinstance(entry, dict):
            return None
        try:
            peaks = entry.get("dtype_peaks") or {}
            return cls(kind, float(entry["peak_flops"]),
                       float(entry["peak_bandwidth"]),
                       float(entry["op_overhead"]),
                       float(entry["call_overhead"]),
                       conv_peak_flops=float(
                           entry.get("conv_peak_flops") or 0) or None,
                       dtype_peaks={str(k): float(v)
                                    for k, v in peaks.items()},
                       source="calibrated")
        except (AttributeError, KeyError, TypeError, ValueError):
            return None

    def persist(self) -> None:
        """Read-merge-write ``device_model.json`` atomically (the
        tuned_kernels.json discipline: unique tmp name, os.replace)."""
        path = self._path()
        if not path:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        models = {}
        try:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, dict) \
                    and data.get("version") == DEVICE_MODEL_VERSION \
                    and isinstance(data.get("models"), dict):
                models = data["models"]
        except (ValueError, OSError):
            pass
        entry = self.to_dict()
        entry.pop("kind", None)
        entry.pop("source", None)
        models[self.kind] = entry
        tmp = "%s.tmp.%d.%d" % (path, os.getpid(), id(self))
        with open(tmp, "w") as f:
            json.dump({"version": DEVICE_MODEL_VERSION, "models": models},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    # ------------------------------------------------------ calibration
    @staticmethod
    def _place(kind: str):
        from ..core.place import CPUPlace, CUDAPlace

        return CUDAPlace(0) if _on_card(kind) else CPUPlace()

    @classmethod
    def _probe_overheads(cls, kind: str):
        """(per-op, per-call) seconds through the port's own executor (on
        the card, replayed CUDA graphs), each the median of
        ``_PROBE_RUNS`` runs (the statistic chip_smoke.py measures a step
        by): the call overhead is an ``Executor.run`` of the one-op
        plan, its fetch included; the per-op overhead is what the
        layer-mix training step takes beyond that, per op of its program
        (``overhead_probe_programs``). Raises on any failure."""
        import numpy as np

        from ..core.executor import Executor
        from ..core.scope import Scope

        exe = Executor(cls._place(kind))

        def median(main, startup, out, feed):
            scope = Scope()
            exe.run(startup, scope=scope)
            for _ in range(3):  # eager, capture, first replay
                exe.run(main, feed=feed, fetch_list=[out], scope=scope)
            t = []
            for _ in range(_PROBE_RUNS):
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[out], scope=scope)
                t.append(time.perf_counter() - t0)
            return float(np.median(t))

        probes = overhead_probe_programs()
        call = median(*probes["call"])
        step = probes["op"]
        n_ops = len(step[0].global_block().ops)
        op = max(median(*step) - call, 0.0) / n_ops
        if not (call > 0 and op > 0):
            raise RuntimeError(
                "the device model's overhead probe measured call %r s, "
                "op %r s on %s" % (call, op, kind))
        return op, call

    @classmethod
    def _probe_conv(cls, kind: str) -> float:
        """The conv class's FLOP/s, measured in the LOW-channel regime
        (first-layer-like 3 -> 32, as the JAX package probes it), under
        the flags the port's convolutions run with (ops.nn._conv_flags:
        deterministic cuDNN, no TF32)."""
        import torch
        import torch.nn.functional as F

        from ..ops.nn import _conv_flags

        dev = torch.device("cuda", 0) if _on_card(kind) \
            else torch.device("cpu")
        cx = torch.ones((8, 3, 56, 56), dtype=torch.float32, device=dev)
        cw = torch.ones((32, 3, 3, 3), dtype=torch.float32, device=dev)
        with _conv_flags():
            secs = _best_seconds(dev, lambda: F.conv2d(cx, cw, padding=1))
        return 2.0 * 8 * 32 * 56 * 56 * 3 * 3 * 3 / secs

    @classmethod
    def _probe_peaks(cls, kind: str):
        """(GEMM FLOP/s, copy bytes/s) measured with torch ops on the
        device."""
        import torch

        dev = torch.device("cuda", 0) if _on_card(kind) \
            else torch.device("cpu")
        n = 512
        a = torch.ones((n, n), dtype=torch.float32, device=dev)
        peak_flops = 2.0 * n * n * n / _best_seconds(
            dev, lambda: torch.mm(a, a))
        m = 1 << 22  # 16 MB f32: big enough to stream, cheap to probe
        v = torch.ones((m,), dtype=torch.float32, device=dev)
        peak_bw = 2.0 * 4 * m / _best_seconds(dev, lambda: v + 1.0)
        return peak_flops, peak_bw

    @classmethod
    def _calibrate(cls, kind: str) -> Optional["DeviceModel"]:
        """Probe the peaks and the overheads on the live device and
        persist, so the probe runs once per machine. On the CPU any
        failure returns None (the caller defaults); on the card it
        raises."""
        try:
            peak_flops, peak_bw = cls._probe_peaks(kind)
            conv_peak = cls._probe_conv(kind)
            op, call = cls._probe_overheads(kind)
        except Exception:
            if _on_card(kind):
                raise
            return None
        model = cls(kind, peak_flops, peak_bw, op, call,
                    conv_peak_flops=min(conv_peak, peak_flops),
                    source="calibrated")
        try:
            model.persist()
        except OSError:
            pass
        return model


def overhead_probe_programs() -> Dict[str, tuple]:
    """The overhead probes' programs, each ``(main, startup, fetch,
    feed)``: ``"call"`` a one-op plan; ``"op"`` a training step of
    ``_PROBE_DEPTH`` tiny residual blocks of each of the two layer
    families the port's models are built of (conv2d + batch_norm +
    relu; fc + layer_norm + relu + dropout), a softmax cross-entropy
    loss and Adam. An op of a model lowers to several kernels (a grad
    op's products and reductions, a norm's statistics, dropout's mask),
    so the probe runs such ops: a chain of tiny fc layers, whose ops
    are one kernel each, prices a model's op at a fraction of its cost
    on the H100 (``tools/torch_overhead_report.py`` compares them)."""
    import numpy as np

    from ..core.program import Program, program_guard
    from .. import layers
    from ..optimizer import Adam

    w, b = _PROBE_WIDTH, _PROBE_BATCH
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", [w], dtype="float32")
        out = layers.elementwise_add(x, x)
    call = (main, startup, out, {"x": np.ones((b, w), "float32")})

    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", [w, w, w], dtype="float32")
        seq = layers.data("seq", [w, w], dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        for _ in range(_PROBE_DEPTH):
            a = layers.conv2d(img, w, 3, padding=1)
            img = layers.elementwise_add(img,
                                         layers.batch_norm(a, act="relu"))
            h = layers.fc(seq, w, num_flatten_dims=2)
            h = layers.layer_norm(h, begin_norm_axis=2, act="relu")
            seq = layers.elementwise_add(seq, layers.dropout(h, 0.1))
        pooled = layers.pool2d(img, pool_type="avg", global_pooling=True)
        feat = layers.concat([layers.reshape(pooled, [-1, w]),
                              layers.reduce_mean(seq, dim=1)], axis=1)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(feat, w), label))
        Adam(learning_rate=1e-3).minimize(loss)
    op = (main, startup, loss, {
        "img": np.ones((b, w, w, w), "float32"),
        "seq": np.ones((b, w, w), "float32"),
        "label": np.zeros((b, 1), "int64")})
    return {"call": call, "op": op}


# ------------------------------------------------------------------ engine
class _OpCost:
    __slots__ = ("op_type", "flops", "bytes", "ruled")

    def __init__(self, op_type: str, flops: BytesPoly, nbytes: BytesPoly,
                 ruled: bool):
        self.op_type = op_type
        self.flops = flops
        self.bytes = nbytes
        self.ruled = ruled


class CostAnalysis:
    """Per-op FLOPs/bytes polynomials + the roofline, for one program's
    global block.

    Walks the block once over a (shared or private) :class:`Dataflow`,
    applies the registered cost rules (``*_grad`` ops ride their base
    op's rule scaled by ``GRAD_FLOPS_FACTOR``), and prices each op's
    bytes generically as its declared inputs + outputs (plus any extra
    bytes the rule returns — e.g. the composed attention score matrix).
    All quantities are polynomials of the batch dim; queries evaluate
    at a concrete batch size. Ops with no rule and no zero-cost
    declaration contribute bytes only and are recorded in ``unruled``
    (counted in ``paddle_cost_unruled_ops_total`` — the shape-ruled
    vocabulary itself can never land there; repo lint rule 10 proves
    that partition)."""

    def __init__(self, program: Program, fetch_names: Sequence[str] = (),
                 scope=None, infer: bool = True,
                 dataflow: Optional[Dataflow] = None, site: str = "api",
                 device: Optional[DeviceModel] = None):
        from ..observe.families import (ANALYSIS_COST_PROGRAMS,
                                        ANALYSIS_COST_SECONDS,
                                        ANALYSIS_COST_UNRULED)

        t0 = time.perf_counter()
        self.program = program
        if infer:
            from .infer import infer_program_shapes

            infer_program_shapes(program, findings=[], fill=True)
        self.df = dataflow if dataflow is not None else Dataflow(
            program, fetch_names=fetch_names, scope=scope)
        self._device = device
        self._dtypes: Dict[tuple, str] = {}
        self.op_costs: List[_OpCost] = []
        self.unruled: List[str] = []
        for i, op in enumerate(self.df.ops):
            self.op_costs.append(self._price(i, op))
        if self.unruled:
            ANALYSIS_COST_UNRULED.inc(len(self.unruled))
        ANALYSIS_COST_PROGRAMS.labels(site=site).inc()
        ANALYSIS_COST_SECONDS.observe(time.perf_counter() - t0)

    # ------------------------------------------------------------ facts
    @property
    def device(self) -> DeviceModel:
        if self._device is None:
            self._device = DeviceModel.current()
        return self._device

    def shape_of(self, name: str):
        v = self.df.var_of(name)
        return None if v is None else v.shape

    def dtype_of(self, name: str):
        v = self.df.var_of(name)
        return None if v is None else v.dtype

    # ---------------------------------------------------------- pricing
    def _generic_bytes(self, pos: int) -> BytesPoly:
        """Declared inputs + outputs, each name once (bytes at rest
        touched by the op — the streaming-traffic floor)."""
        total = BytesPoly()
        seen = set()
        for name in tuple(self.df.reads[pos]) + tuple(self.df.writes[pos]):
            if not name or name in seen:
                continue
            seen.add(name)
            v = self.df.var_of(name)
            if v is None or v.shape is None:
                continue
            total = total + BytesPoly.from_dims(
                tuple(v.shape), dtype_bytes(v.dtype or "float32",
                                            warn=False))
        return total

    def _price(self, pos: int, op) -> _OpCost:
        zero = BytesPoly()
        op_type = op.type
        if op_type in ZERO_COST:
            return _OpCost(op_type, zero, zero, True)
        rule = COST_RULES.get(op_type)
        scale = 1.0
        if rule is None and op_type.endswith("_grad"):
            base = op_type[: -len("_grad")]
            if base in ZERO_COST:
                return _OpCost(op_type, zero, zero, True)
            rule = COST_RULES.get(base)
            scale = GRAD_FLOPS_FACTOR
        nbytes = self._generic_bytes(pos)
        if rule is None:
            self.unruled.append(op_type)
            return _OpCost(op_type, zero, nbytes, False)
        try:
            got = rule(CostContext(op, self))
        except Exception:
            got = None
        extra = None
        if isinstance(got, tuple):
            got, extra = got
        flops = got.scaled(scale) if got is not None else zero
        if extra is not None:
            nbytes = nbytes + extra
        return _OpCost(op_type, flops, nbytes, got is not None)

    # ---------------------------------------------------------- queries
    def flops_poly(self) -> BytesPoly:
        total = BytesPoly()
        for c in self.op_costs:
            total = total + c.flops
        return total

    def bytes_poly(self) -> BytesPoly:
        total = BytesPoly()
        for c in self.op_costs:
            total = total + c.bytes
        return total

    def flops(self, batch_size: int = 1) -> int:
        return self.flops_poly().at(batch_size)

    def bytes_moved(self, batch_size: int = 1) -> int:
        return self.bytes_poly().at(batch_size)

    def product_dtype(self, op_type: str) -> str:
        """The dtype op ``op_type``'s product runs in on the card:
        ``"bfloat16"`` for an op ``core/amp.py`` casts to bf16 when the
        program is under AMP, ``"tf32"`` for a matmul-family op (its grad
        included) while ``torch.backends.cuda.matmul.allow_tf32`` is on,
        ``"float32"`` otherwise."""
        import torch

        from ..core.amp import policy_for

        tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
        key = (op_type, tf32)
        got = self._dtypes.get(key)
        if got is None:
            base = op_type[:-len("_grad")] if op_type.endswith("_grad") \
                else op_type
            if getattr(self.program, "amp", False) \
                    and policy_for(op_type) == "bf16":
                got = "bfloat16"
            elif base in _TF32_OPS and tf32:
                got = "tf32"
            else:
                got = "float32"
            self._dtypes[key] = got
        return got

    def _compute_peak(self, dev: "DeviceModel", op_type: str) -> float:
        """The op's compute ceiling: the peak of the dtype its product
        runs in (``product_dtype``); an f32 conv-family op divides by
        the conv-class peak (DeviceModel docstring)."""
        dtype = self.product_dtype(op_type)
        if dtype == "float32" and "conv" in op_type:
            return dev.conv_peak_flops
        return dev.peak_for(dtype)

    def program_peak(self) -> float:
        """The peak of the program's products (bf16 under AMP, TF32
        where torch allows it, else f32): what ``predicted_mfu``
        divides by."""
        return self.device.peak_for(self.product_dtype("mul"))

    def op_seconds(self, pos: int, batch_size: int = 1) -> float:
        """One op's roofline: max(compute time, memory time) plus the
        per-op scheduling overhead."""
        c = self.op_costs[pos]
        dev = self.device
        return max(c.flops.at(batch_size) / self._compute_peak(
                       dev, c.op_type),
                   c.bytes.at(batch_size) / dev.peak_bandwidth) \
            + dev.op_overhead

    def predicted_seconds(self, batch_size: int = 1,
                          steps_per_call: int = 1) -> float:
        """Predicted PER-STEP seconds at ``batch_size`` when K steps
        run per dispatched call: the roofline sum plus the per-call
        host overhead amortized by K."""
        k = max(1, int(steps_per_call))
        dev = self.device
        total = sum(self.op_seconds(i, batch_size)
                    for i in range(len(self.op_costs)))
        return total + dev.call_overhead / k

    def predicted_mfu(self, batch_size: int = 1,
                      steps_per_call: int = 1) -> float:
        """Model FLOPs utilization the roofline PREDICTS (analytic
        flops over predicted wall time at the peak of the program's
        products) — what the step would score if it ran exactly as
        modeled."""
        secs = self.predicted_seconds(batch_size, steps_per_call)
        if secs <= 0:
            return 0.0
        return self.flops(batch_size) / (secs * self.program_peak())

    def bound(self, pos: int, batch_size: int = 1) -> str:
        """"compute" | "memory" | "overhead": which roofline term
        dominates op ``pos`` at ``batch_size``."""
        c = self.op_costs[pos]
        dev = self.device
        ct = c.flops.at(batch_size) / self._compute_peak(dev, c.op_type)
        mt = c.bytes.at(batch_size) / dev.peak_bandwidth
        if max(ct, mt) < dev.op_overhead:
            return "overhead"
        return "compute" if ct >= mt else "memory"

    def table(self, batch_size: int = 1) -> List[dict]:
        """Per-op roofline rows (tools/torch_cost_report.py's table)."""
        out = []
        for i, c in enumerate(self.op_costs):
            out.append({
                "pos": i, "op_type": c.op_type,
                "flops": c.flops.at(batch_size),
                "bytes": c.bytes.at(batch_size),
                "seconds": self.op_seconds(i, batch_size),
                "bound": self.bound(i, batch_size),
                "ruled": c.ruled,
            })
        return out

    def by_op_type(self, batch_size: int = 1) -> List[dict]:
        """The table aggregated by op type, most expensive first."""
        agg: Dict[str, dict] = {}
        for row in self.table(batch_size):
            a = agg.setdefault(row["op_type"],
                               {"op_type": row["op_type"], "count": 0,
                                "flops": 0, "bytes": 0, "seconds": 0.0})
            a["count"] += 1
            a["flops"] += row["flops"]
            a["bytes"] += row["bytes"]
            a["seconds"] += row["seconds"]
        return sorted(agg.values(), key=lambda a: -a["seconds"])


def predict_step_seconds(program: Program, batch_size: int = 1,
                         fetch_names: Sequence[str] = (), scope=None,
                         steps_per_call: int = 1,
                         site: str = "api") -> float:
    """One-call convenience: the roofline-predicted per-step seconds."""
    return CostAnalysis(program, fetch_names=fetch_names, scope=scope,
                        site=site).predicted_seconds(
        batch_size, steps_per_call=steps_per_call)
