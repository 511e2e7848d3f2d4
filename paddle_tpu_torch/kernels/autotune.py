"""ONE global autotuner: predict with the roofline, prune, measure
only survivors.

The port of paddle_tpu/kernels/autotune.py. It searches the joint
candidate space of the port's tuners, the kernel axis
(``kernels/tune.py``: flash against composed attention per (Sq, Sk)),
the train-window length K (``core/window_tune.py``) and the int8
quantize toggle, built on the cost engine (``analysis/cost.py``): every
candidate is RANKED by predicted cost first, everything outside the top
few per signature is pruned without measurement, and only the survivors
go through the existing measurement machinery (``tune.tune`` /
``tune_train_window``), TVM's predict-prune-measure loop.

What stays as it was: winners persist in the port's two-choice grammar
(``{"choice": "cuda"|"composed", "cfg", "seconds"}``) through the same
``tuned_kernels.json``; the composed / K=1 fallbacks are never pruned;
bitwise contracts and the ``PADDLE_TPU_KERNELS=0`` bypass are
untouched. ``PADDLE_TPU_COST_MODEL=0`` degrades every search to
measure-everything with zero ``paddle_cost_*`` family movement.

The per-candidate kernel model: the kernel's own FLOPs / bytes at its
signature, a padding-waste factor for a blocked launch config (a block
of 512 rows over 520 rows wastes ~49%), and a per-block scheduling
overhead. The flash kernel has one launch configuration, ``()``: its
grid is unmodeled (``_grid_shape`` returns None), which measures
everything, exactly right for a grid of one. Candidates tie-break by
label so the ranking is total and deterministic.

Counters: ``paddle_autotune_runs_total{axis}``,
``paddle_autotune_pruned_total{axis}``,
``paddle_autotune_measured_total{axis}``.
``PADDLE_TPU_AUTOTUNE_KEEP`` overrides how many ranked candidates
survive per signature (default: half the grid, floor 1).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analysis.cost import CostAnalysis, DeviceModel, cost_model_enabled
from ..analysis.memory import dtype_bytes
from . import tune

__all__ = ["autotune_kernel", "autotune_program", "autotune_window",
           "keep_count", "predicted_candidate_seconds",
           "prune_candidates", "quantize_outlook"]

_LANES = 128  # the optimizer sweep's row of elements (a blocked config)


def keep_count(n: int) -> int:
    """Survivors per ranked grid: ``PADDLE_TPU_AUTOTUNE_KEEP`` (>= 1),
    default half the grid (floor 1) — the measured set stays <= half of
    every joint candidate grid."""
    raw = os.environ.get("PADDLE_TPU_AUTOTUNE_KEEP", "").strip()
    if raw:
        try:
            k = int(raw)
        except ValueError:
            raise ValueError("PADDLE_TPU_AUTOTUNE_KEEP must be an "
                             "integer; got %r" % raw) from None
        if k < 1:
            raise ValueError(
                "PADDLE_TPU_AUTOTUNE_KEEP must be >= 1, got %d" % k)
        return min(k, n)
    return max(1, n // 2)


# ------------------------------------------------- per-kernel workload
def _attn_tune_dims() -> Tuple[int, int, int]:
    from ..ops import attention as _attn

    return _attn._TUNE_B, _attn._TUNE_H, _attn._TUNE_D


def _kernel_workload(op: str, sig: Tuple) -> Optional[Tuple[float, float]]:
    """(FLOPs, bytes moved) of one kernel invocation at ``sig``: the
    JAX package's constants, the same coarse ones as
    analysis/cost_rules.py, specialized to the tuner's synthetic
    workloads. None = unknown op (no pruning)."""
    if op == "attention":
        b, h, d = _attn_tune_dims()
        sq, sk = int(sig[0]), int(sig[1])
        flops = 4.0 * b * h * sq * sk * d + 10.0 * b * h * sq * sk
        nbytes = 4.0 * b * h * ((sq + 2 * sk) * d + sq * d)
        return flops, nbytes
    if op == "layernorm_residual":
        dt, n, d = sig[0], int(sig[1]), int(sig[2])
        elems = float(n) * d
        return 8.0 * elems, 4.0 * elems * dtype_bytes(dt, warn=False)
    if op == "adam_update":
        dt, n = sig[0], int(sig[1])
        return 12.0 * n, 7.0 * n * dtype_bytes(dt, warn=False)
    if op == "sgd_update":
        dt, n = sig[0], int(sig[1])
        return 2.0 * n, 3.0 * n * dtype_bytes(dt, warn=False)
    return None


def _grid_shape(op: str, sig: Tuple, cfg) -> Optional[Tuple[float, int]]:
    """(padding-waste factor >= 1, grid steps) for one block config.
    None = unmodeled config shape (no pruning for this candidate): the
    flash kernel's one configuration ``()`` among them, whose tiles are
    the built kernel's own (``ops/attention.py``); a (bq, bk) tile pair
    and a row block are modeled."""
    try:
        if op == "attention" and len(cfg) == 2:
            sq, sk = int(sig[0]), int(sig[1])
            bq, bk = int(cfg[0]), int(cfg[1])
            padq = math.ceil(sq / bq) * bq
            padk = math.ceil(sk / bk) * bk
            waste = (padq / sq) * (padk / sk)
            return waste, math.ceil(sq / bq) * math.ceil(sk / bk)
        if op == "layernorm_residual" and len(cfg) == 1:
            n = int(sig[1])
            bn = int(cfg[0])
            pad = math.ceil(n / bn) * bn
            return pad / n, math.ceil(n / bn)
        if op in ("adam_update", "sgd_update") and len(cfg) == 1:
            rows = max(1, math.ceil(int(sig[1]) / _LANES))
            br = int(cfg[0])
            pad = math.ceil(rows / br) * br
            return pad / rows, math.ceil(rows / br)
    except (TypeError, ValueError, ZeroDivisionError):
        return None
    return None


def predicted_candidate_seconds(op: str, sig: Tuple, cfg,
                                device: Optional[DeviceModel] = None
                                ) -> Optional[float]:
    """Roofline-predicted seconds of one (op, sig, cfg) kernel
    invocation: max(compute, memory) inflated by the padding waste,
    plus per-grid-step scheduling overhead. None = unmodeled (the
    candidate is never pruned on an unknown)."""
    work = _kernel_workload(op, sig)
    grid = _grid_shape(op, sig, cfg)
    if work is None or grid is None:
        return None
    dev = device or DeviceModel.current()
    flops, nbytes = work
    waste, steps = grid
    return max(flops * waste / dev.peak_flops,
               nbytes * waste / dev.peak_bandwidth) \
        + steps * dev.op_overhead + dev.call_overhead


def prune_candidates(op: str, sig: Tuple, candidates=None
                     ) -> Tuple[List, List[Dict[str, Any]]]:
    """Rank ``op``'s candidate grid at ``sig`` by predicted cost and
    keep the top ``keep_count``; returns (survivors, pruned) where each
    pruned record carries the prediction that killed it. With the cost
    model off, or any candidate unmodeled, everything survives — a
    prediction gap must degrade to measure-everything, never to a
    silent mis-prune."""
    from .registry import get_kernel

    cands = list(candidates if candidates is not None
                 else get_kernel(op).candidates(sig))
    if not cost_model_enabled() or len(cands) <= 1:
        return cands, []
    dev = DeviceModel.current()
    scored = []
    for cfg in cands:
        secs = predicted_candidate_seconds(op, sig, cfg, device=dev)
        if secs is None:
            return cands, []
        scored.append((secs, "cuda:%s" % (list(cfg),), cfg))
    scored.sort(key=lambda t: (t[0], t[1]))
    keep = keep_count(len(scored))
    survivors = [cfg for _s, _l, cfg in scored[:keep]]
    pruned = [{"cfg": list(cfg), "label": label,
               "predicted_seconds": secs}
              for secs, label, cfg in scored[keep:]]
    return survivors, pruned


def autotune_kernel(op: str, sig: Tuple,
                    attrs: Optional[Dict[str, Any]] = None,
                    candidates=None) -> Dict[str, Any]:
    """The kernel/flash axis of the global search: prune the block-
    config grid by predicted cost, then measure survivors + the
    composed fallback through ``tune.tune`` exactly as today (winner
    grammar, persistence, plan-cache epoch all unchanged). The
    returned decision additionally carries the non-persisted
    ``pruned`` records."""
    from ..observe.families import (AUTOTUNE_MEASURED, AUTOTUNE_PRUNED,
                                    AUTOTUNE_RUNS)

    survivors, pruned = prune_candidates(op, sig, candidates)
    AUTOTUNE_RUNS.labels(axis="kernel").inc()
    if pruned:
        AUTOTUNE_PRUNED.labels(axis="kernel").inc(len(pruned))
    # +1: tune() always measures the composed fallback too
    AUTOTUNE_MEASURED.labels(axis="kernel").inc(len(survivors) + 1)
    decision = dict(tune.tune(op, sig, attrs, candidates=survivors))
    if pruned:
        decision["pruned"] = pruned
    return decision


# ------------------------------------------------------- window axis
def autotune_window(executor, program, feed: Dict[str, Any],
                    fetch_list: Optional[Sequence] = None, scope=None,
                    *, candidates: Optional[Sequence[int]] = None,
                    persist: bool = True) -> Dict[str, Any]:
    """The train-window axis: rank candidate Ks by the cost engine's
    predicted per-step seconds (the per-call host overhead amortizes by
    K — exactly the effect a window buys), prune the bottom half, and
    measure survivors through ``tune_train_window``. K=1, the mandatory
    composed fallback, is never pruned (the memory pruner's rule);
    pruned Ks still appear in the decision's timings with
    ``pruned: True`` and the predicted seconds that killed them."""
    from ..core import window_tune
    from ..observe.families import (AUTOTUNE_MEASURED, AUTOTUNE_PRUNED,
                                    AUTOTUNE_RUNS)

    cands = sorted({max(1, int(c)) for c in (
        candidates if candidates is not None
        else window_tune.window_candidates())})
    if 1 not in cands:
        cands.insert(0, 1)
    AUTOTUNE_RUNS.labels(axis="window").inc()
    cost_pruned: Dict[int, float] = {}
    if cost_model_enabled() and len([k for k in cands if k > 1]) > 1:
        try:
            fetch_names = [getattr(v, "name", str(v))
                           for v in (fetch_list or [])]
            ca = CostAnalysis(program, fetch_names=fetch_names,
                              scope=scope, site="autotune")
            batch = window_tune._feed_batch_size(feed)
            ranked = sorted(
                ((ca.predicted_seconds(batch, steps_per_call=k), k)
                 for k in cands if k > 1))
            keep = keep_count(len(ranked))
            cost_pruned = {k: s for s, k in ranked[keep:]}
        except Exception:
            # a prediction failure degrades to measure-everything
            cost_pruned = {}
    if cost_pruned:
        AUTOTUNE_PRUNED.labels(axis="window").inc(len(cost_pruned))
    AUTOTUNE_MEASURED.labels(axis="window").inc(
        len(cands) - len(cost_pruned))
    return window_tune.tune_train_window(
        executor, program, feed, fetch_list, scope, candidates=cands,
        persist=persist, cost_pruned=cost_pruned)


# ----------------------------------------------------- quantize axis
def quantize_outlook(program, feed: Dict[str, Any],
                     fetch_list: Optional[Sequence] = None, scope=None
                     ) -> Optional[Dict[str, Any]]:
    """The quantize on/off axis, priced analytically: when the PTQ pass
    is armed (``PADDLE_TPU_OPTIMIZE_QUANT=1``), predict the step-time
    payoff of int8 weights — each statically eligible weight stops
    moving 3/4 of its bytes through its consumers. Measurement stays
    with the pass's own tolerance/TV harness; this axis only RANKS the
    toggle (None = pass unarmed or cost model off)."""
    from ..core.passes.quantize_pass import (quantize_enabled,
                                             quantizable_weight_names)
    from ..core.window_tune import _feed_batch_size

    if not quantize_enabled() or not cost_model_enabled():
        return None
    fetch_names = [getattr(v, "name", str(v)) for v in (fetch_list or [])]
    ca = CostAnalysis(program, fetch_names=fetch_names, scope=scope,
                      site="autotune")
    batch = _feed_batch_size(feed)
    weights = quantizable_weight_names(program)
    base = ca.predicted_seconds(batch)
    dev = ca.device
    saved = 0.0
    for pos, c in enumerate(ca.op_costs):
        op = ca.df.ops[pos]
        wnames = [n for names in op.inputs.values() for n in names or ()
                  if n in weights]
        if not wnames:
            continue
        wbytes = sum(weights[n] * 4 for n in set(wnames))
        peak = ca._compute_peak(dev, op.type)
        old = max(c.flops.at(batch) / peak,
                  c.bytes.at(batch) / dev.peak_bandwidth)
        new = max(c.flops.at(batch) / peak,
                  max(0.0, c.bytes.at(batch) - 0.75 * wbytes)
                  / dev.peak_bandwidth)
        saved += max(0.0, old - new)
    predicted_quantized = max(0.0, base - saved)
    return {"weights": len(weights),
            "predicted_seconds": base,
            "predicted_seconds_quantized": predicted_quantized,
            "predicted_speedup": (base / predicted_quantized
                                  if predicted_quantized > 0 else 1.0),
            "recommended": saved > 0.02 * base}


# ------------------------------------------------------ the ONE search
def _attention_sigs(program) -> List[Tuple[int, int]]:
    """(Sq, Sk) kernel signatures of the program's fused_attention ops
    (post shape inference) — the flash-threshold axis enumerates these."""
    sigs = set()
    for block in program.blocks:
        for op in block.ops:
            if op.type != "fused_attention":
                continue
            qn = (op.inputs.get("Q") or [None])[0]
            kn = (op.inputs.get("K") or [None])[0]
            qv = block._find_var_recursive(qn) if qn else None
            kv = block._find_var_recursive(kn) if kn else None
            qs = getattr(qv, "shape", None)
            ks = getattr(kv, "shape", None)
            if not qs or not ks or len(qs) < 2 or len(ks) < 2:
                continue
            sq, sk = int(qs[-2]), int(ks[-2])
            if sq > 0 and sk > 0:
                sigs.add((sq, sk))
    return sorted(sigs)


def autotune_program(executor, program, feed: Dict[str, Any],
                     fetch_list: Optional[Sequence] = None, scope=None,
                     *, persist: bool = True) -> Dict[str, Any]:
    """The whole joint space for one (program, feed) in one call:

    * the train-window K axis (``autotune_window``);
    * one kernel/flash axis per fused_attention signature in the
      program (``autotune_kernel("attention", (sq, sk))`` — the tuned
      entry is exactly what ``flash_effective`` consumes as its
      precedence tier 2);
    * the quantize on/off outlook where the PTQ pass is armed.

    Winners land in the same caches the three old per-tuner entry
    points fed, so every consumer (dispatch, ``resolve_steps_per_call``,
    the plan-cache key) picks them up with no new wiring. Returns a
    report with one entry per axis searched."""
    from ..analysis.infer import infer_program_shapes

    infer_program_shapes(program, findings=[], fill=True)
    report: Dict[str, Any] = {"axes": []}
    window = autotune_window(executor, program, feed, fetch_list, scope,
                             persist=persist)
    report["axes"].append({"axis": "window", "decision": window})
    for sig in _attention_sigs(program):
        dec = autotune_kernel("attention", sig)
        report["axes"].append({"axis": "kernel", "op": "attention",
                               "sig": list(sig), "decision": dec})
    outlook = quantize_outlook(program, feed, fetch_list, scope)
    if outlook is not None:
        report["axes"].append({"axis": "quantize", "outlook": outlook})
    return report
