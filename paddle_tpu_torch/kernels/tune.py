"""Per-shape kernel autotuner with a persisted winner cache.

The port of paddle_tpu/kernels/tune.py. Instead of a fixed threshold
picking between a hand-written CUDA kernel and the composed PyTorch
math, the choice is MEASURED per (op, input signature) over the
kernel's launch candidates plus the composed path, and the winner is
persisted so no process pays the measurement twice. The choice
vocabulary is ``"cuda"`` | ``"composed"``. The one registered op is
``attention`` (ops/attention.py): its winner is tier 2 of the flash
precedence.

Cache layout (``PADDLE_TPU_KERNEL_CACHE_DIR``; default
``~/.cache/paddle_tpu_torch/kernels``, apart from the JAX package's, so
neither package reads the other's winners; set to ``0`` to disable
persistence): one JSON file ``tuned_kernels.json``::

    {"version": 1,
     "entries": {"attention|512,512":
                 {"choice": "cuda", "cfg": [], "seconds": 1.2e-4}}}

Writes are atomic tmp+rename with a read-merge-write cycle so
concurrent tuners don't torch each other's entries. Corrupt files and
version-skewed entries degrade to cache MISSES (re-tune), never
crashes.

Measurement: on the card, CUDA events around each of
``PADDLE_TPU_KERNEL_TUNE_REPEATS`` (default 3) calls after one warm-up
call per candidate, the best kept. Setting
``PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC=<seed>`` replaces timing with a
stable hash of (seed, op, sig, candidate) — the CPU tests pin tuner
BEHAVIOR (selection, persistence, counters) without a card; every
candidate's launch checks (``KernelDef.check``) are asserted either
way. A candidate that fails to build or launch fails the tune: nothing
is persisted for it.

The port's lowerings consult the table at every run, so nothing here
keys the executor's plan cache.

Counters: ``paddle_kernel_tuner_hits_total{tier=memory|disk}``,
``paddle_kernel_tuner_misses_total``, ``paddle_kernel_tune_seconds``,
``paddle_kernel_winners_total{op,choice}``.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CACHE_VERSION", "CHOICES", "cache_dir", "cache_path",
           "deterministic_seed", "epoch", "lookup", "tune", "set_entry",
           "load_disk_entries", "persist_entry", "reset", "sig_key"]

CACHE_VERSION = 1
CACHE_FILE = "tuned_kernels.json"
CHOICES = ("cuda", "composed")

_MEM: Dict[str, Dict[str, Any]] = {}
_LOCK = threading.RLock()
_DISK_LOADED_FOR: Optional[str] = None  # the path entries were loaded from
_EPOCH = 0  # bumped by every change of the in-memory table
_TMP_SEQ = itertools.count(1)


def cache_dir() -> Optional[str]:
    """Winner-cache directory, or None when persistence is disabled
    (``PADDLE_TPU_KERNEL_CACHE_DIR=0`` or empty-string)."""
    raw = os.environ.get("PADDLE_TPU_KERNEL_CACHE_DIR")
    if raw is None:
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "paddle_tpu_torch", "kernels")
    raw = raw.strip()
    if raw in ("", "0"):
        return None
    return raw


def cache_path() -> Optional[str]:
    d = cache_dir()
    return os.path.join(d, CACHE_FILE) if d else None


def deterministic_seed() -> Optional[int]:
    raw = os.environ.get("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", "")
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            "PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC must be a decimal "
            "integer seed; got %r" % (raw,)) from None


def _repeats() -> int:
    try:
        return max(1, int(os.environ.get(
            "PADDLE_TPU_KERNEL_TUNE_REPEATS", "3")))
    except ValueError:
        return 3


def sig_key(op: str, sig: Tuple) -> str:
    return "%s|%s" % (op, ",".join(str(s) for s in sig))


# ------------------------------------------------------------------ disk
def load_disk_entries(path: Optional[str] = None) -> Dict[str, Dict]:
    """Entries from the winner file; corrupt JSON, a non-dict payload, or
    a version-skewed file all read as EMPTY (misses — the tuner re-tunes
    and the next persist rewrites the file at the current version)."""
    path = path or cache_path()
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
    except (ValueError, OSError):
        return {}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        return {}
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return {}
    return {k: v for k, v in entries.items()
            if isinstance(v, dict) and v.get("choice") in CHOICES}


def _ensure_disk_loaded() -> None:
    """One-shot promote of the disk winners into the in-memory table
    (per cache path — switching PADDLE_TPU_KERNEL_CACHE_DIR mid-process
    reloads)."""
    global _DISK_LOADED_FOR, _EPOCH
    path = cache_path()
    with _LOCK:
        if _DISK_LOADED_FOR == path:
            return
        _DISK_LOADED_FOR = path
        _EPOCH += 1
        if path:
            for k, v in load_disk_entries(path).items():
                _MEM.setdefault(k, dict(v, source="disk"))


def persist_entry(key: str, decision: Dict[str, Any],
                  path: Optional[str] = None) -> None:
    """Read-merge-write the winner file atomically (tmp+rename, unique
    staging name per writer): concurrent writers merge through the
    re-read; the final ``os.replace`` can lose a same-instant sibling's
    newest entry but never corrupts the file — the loser re-tunes."""
    path = path or cache_path()
    if not path:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    entries = load_disk_entries(path)
    entries[key] = {k: v for k, v in decision.items() if k != "source"}
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), next(_TMP_SEQ))
    with open(tmp, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                  indent=1, sort_keys=True)
    os.replace(tmp, path)


# ---------------------------------------------------------------- lookup
def lookup(op: str, sig: Tuple) -> Optional[Dict[str, Any]]:
    """Tuned decision for (op, sig), or None (miss). Memory first, then
    the one-shot disk load; every call moves exactly one hit or miss
    counter — the end-to-end acceptance test pins 'second process serves
    everything from disk, zero tune invocations' on these."""
    from ..observe.families import KERNEL_TUNER_HITS, KERNEL_TUNER_MISSES

    key = sig_key(op, sig)
    with _LOCK:
        dec = _MEM.get(key)
        if dec is not None:
            KERNEL_TUNER_HITS.labels(
                tier="disk" if dec.get("source") == "disk"
                else "memory").inc()
            return dec
        _ensure_disk_loaded()
        dec = _MEM.get(key)
        if dec is not None:
            KERNEL_TUNER_HITS.labels(tier="disk").inc()
            return dec
    KERNEL_TUNER_MISSES.inc()
    return None


def peek(op: str, sig: Tuple) -> Optional[Dict[str, Any]]:
    """``lookup`` without the hit/miss counters: the resolution probe
    for callers that consult the table on EVERY loop entry (the windowed
    train loop's steps_per_call resolution, core/window_tune.py) — a
    per-loop probe must not move the lookup counters the kernel tier's
    tests pin."""
    key = sig_key(op, sig)
    with _LOCK:
        dec = _MEM.get(key)
        if dec is not None:
            return dec
        _ensure_disk_loaded()
        return _MEM.get(key)


def set_entry(op: str, sig: Tuple, decision: Dict[str, Any],
              persist: bool = False) -> None:
    """Install a decision directly (tests inject winners); the next
    dispatch reads it."""
    global _EPOCH
    key = sig_key(op, sig)
    with _LOCK:
        _MEM[key] = dict(decision)
        _EPOCH += 1
    if persist:
        persist_entry(key, decision)


def reset() -> None:
    """Forget every in-memory decision and the disk-loaded flag
    (tests)."""
    global _DISK_LOADED_FOR, _EPOCH
    with _LOCK:
        _MEM.clear()
        _DISK_LOADED_FOR = None
        _EPOCH += 1


def epoch() -> int:
    """The table's epoch, bumped by ``set_entry``, ``reset`` and the
    one-shot disk load (which this call forces): a CUDA graph captured
    under one epoch read the table then, and is captured anew under
    another (core/executor.py)."""
    _ensure_disk_loaded()
    return _EPOCH


# ------------------------------------------------------------ measurement
def _fake_seconds(seed: int, op: str, sig: Tuple, label: str) -> float:
    """Deterministic stand-in timing: a stable hash of (seed, op, sig,
    candidate label) mapped into (1, 2) ms. Selection becomes a pure
    function of the inputs — tier-1 tests never flake on timing."""
    h = hashlib.sha256(
        ("%d|%s|%s|%s" % (seed, op, ",".join(map(str, sig)), label))
        .encode()).hexdigest()
    return 1e-3 * (1.0 + int(h[:8], 16) / 0xffffffff)


def _measure(fn, args, attrs, repeats: int) -> float:
    """Seconds per call on the card: CUDA events around each of
    ``repeats`` calls after one warm-up call, the best kept."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def once() -> float:
        start.record()
        fn(*args, **attrs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    once()  # warm-up: first launch, kernel load
    return min(once() for _ in range(repeats))


def _on_card(args):
    """The synthetic inputs (CPU tensors, possibly in lists and dicts)
    moved to the card the measurement runs on."""
    import torch

    if isinstance(args, torch.Tensor):
        return args.to("cuda")
    if isinstance(args, dict):
        return {k: _on_card(v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(_on_card(v) for v in args)
    return args


def tune(op: str, sig: Tuple, attrs: Optional[Dict[str, Any]] = None,
         candidates=None) -> Dict[str, Any]:
    """Measure every launch candidate of ``op`` at ``sig`` plus the
    composed fallback on the card, persist the winner, and return the
    decision (its ``timings`` hold every candidate's seconds).
    ``candidates`` overrides the KernelDef's list.

    Every candidate's launch checks are ASSERTED (``KernelDef.check``)
    before anything runs — including in deterministic mode — so an
    illegal candidate fails the tune loudly instead of being silently
    skipped. A candidate that fails to build or launch during
    measurement fails the tune with its error, and nothing is persisted.
    Measuring needs a card; deterministic mode needs none."""
    from ..observe import trace as _tr
    from ..observe.families import KERNEL_TUNE_SECONDS, KERNEL_WINNERS
    from .registry import get_kernel

    kdef = get_kernel(op)
    attrs = dict(attrs or {})
    seed = deterministic_seed()
    repeats = _repeats()
    t0 = time.perf_counter()
    with _tr.trace_span("kernel.tune", op=op, sig=str(sig)):
        cands = list(candidates if candidates is not None
                     else kdef.candidates(sig))
        for cfg in cands:
            kdef.check(cfg, sig)  # launch checks, asserted for EVERY one
        timings: List[Dict[str, Any]] = []
        args = None
        if seed is None:
            import numpy as np
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "tuning %s measures on the card and no CUDA device is "
                    "visible (PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC tunes "
                    "without one)" % op)
            args = _on_card(kdef.make_inputs(sig,
                                             np.random.RandomState(0)))
        for cfg in cands:
            label = "cuda:%s" % (list(cfg),)
            if seed is not None:
                secs = _fake_seconds(seed, op, sig, label)
            else:
                secs = _measure(
                    lambda *a, _c=cfg, **kw: kdef.pallas(_c, *a, **kw),
                    args, attrs, repeats)
            timings.append({"label": label, "cfg": list(cfg),
                            "choice": "cuda", "seconds": secs})
        if seed is not None:
            secs = _fake_seconds(seed, op, sig, "composed")
        else:
            secs = _measure(kdef.fallback, args, attrs, repeats)
        timings.append({"label": "composed", "cfg": None,
                        "choice": "composed", "seconds": secs})
        best = min(timings, key=lambda t: t["seconds"])
        decision: Dict[str, Any] = {
            "choice": best["choice"], "cfg": best["cfg"],
            "seconds": best["seconds"], "source": "tuned",
            "timings": timings,
        }
        set_entry(op, sig, decision, persist=True)
    KERNEL_TUNE_SECONDS.observe(time.perf_counter() - t0)
    KERNEL_WINNERS.labels(op=op, choice=best["choice"]).inc()
    return decision
