"""Autotuned training-step window size (the K of ``steps_per_call``).

The port's counterpart of paddle_tpu/core/window_tune.py. The number of
train steps run per dispatch by ``Executor.run_pipelined`` /
``train_loop`` is a tunable like a kernel's choice: on the card a window
of K steps is K replays of the plan's CUDA graph with no host sync
between them, and its stacked feeds cross to the card in one copy per
feed. The right K is a property of (model, batch shape, card), so it is
MEASURED, not guessed.

The tunable rides the kernel tier's tuner (``kernels/tune.py``):

* op name ``WINDOW_OP = "train_window"`` — declared in
  ``families._KERNEL_OPS`` so the ``paddle_kernel_winners_total`` /
  ``dispatches_total`` schema pre-materializes it.
* signature ``(program fingerprint, per-feed name:shape:dtype ...)`` —
  the fingerprint is a STABLE hash of the program's op structure (not
  the process-local serial), so a winner tuned in one process serves
  every later one from ``tuned_kernels.json``.
* candidates ``{1, 4, 10, 25, 50}`` (``PADDLE_TPU_WINDOW_CANDIDATES``
  overrides); K=1 — the per-step loop — is the MANDATORY fallback and is
  recorded as choice ``"composed"``; a K>1 winner is choice
  ``"cuda"`` with ``cfg=[K]`` (the port's tuner file grammar, where the
  JAX package writes ``"pallas"``).
* measurement: per-step seconds of one warmed K-step dispatch
  (``run_repeated(steps=K, feed_stacked=True)``) against the per-step
  ``run()`` loop, best-of-``PADDLE_TPU_KERNEL_TUNE_REPEATS``; the scope's
  state (params, optimizer slots, the RNG chain) is snapshotted before
  and restored after EVERY candidate — as copies, since a replay updates
  the scope's tensors in place — so training resumes bitwise from the
  pre-tune state. ``PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC=<seed>``
  replaces timing with the tuner's stable hash.
* the winner persists through ``tune.set_entry(..., persist=True)``,
  which bumps the table's epoch: a plan's CUDA graph captured under the
  old table is captured anew (core/executor.py).

Resolution (``resolve_steps_per_call``) is what the pipelined loop
consults when no explicit ``steps_per_call`` was passed: explicit arg >
``PADDLE_TPU_STEPS_PER_CALL`` env > tuned ``train_window`` entry >
default 1. The tuned probe uses ``tune.peek`` (counter-free).

Memory-aware pruning: a window of K stacks K batches on the device, so
with a device budget configured (``PADDLE_TPU_DEVICE_HBM_BYTES``) the
tuner asks the static memory engine (``analysis/memory.py``) for each
candidate's predicted peak and skips over-budget candidates WITHOUT
measuring them, counted in ``paddle_analysis_memory_pruned_total``; K=1
is never pruned.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["WINDOW_OP", "DEFAULT_CANDIDATES", "program_fingerprint",
           "window_signature", "window_candidates", "tuned_window",
           "resolve_steps_per_call", "tune_train_window"]

WINDOW_OP = "train_window"
DEFAULT_CANDIDATES = (1, 4, 10, 25, 50)


def program_fingerprint(program) -> str:
    """Stable short hex of the program's OP structure: block op types
    with their sorted input/output wiring and attrs. Unlike
    ``program._serial`` (a process-local id), two processes building
    the same model graph get the SAME fingerprint — the property that
    lets a persisted ``train_window`` winner serve every later process.
    Variable shape/dtype ANNOTATIONS are deliberately excluded: the
    prepare-time verifier (PADDLE_TPU_VALIDATE=1) fills inferred shapes
    back onto Variables, so including them would change a program's
    fingerprint after its first prepare; the op wiring plus the feed
    shapes in the tuner signature pin the computation without them.
    Attr values with no stable identity (rare: raw arrays, closures)
    contribute their type name only; that keeps the fingerprint total
    rather than making whole programs untunable."""
    from ..analysis.dataflow import Unfingerprintable, attrs_fingerprint

    h = hashlib.sha1()
    for bi, block in enumerate(program.blocks):
        h.update(b"B%d" % bi)
        for op in block.ops:
            ins = sorted((k, tuple(v)) for k, v in op.inputs.items())
            outs = sorted((k, tuple(v)) for k, v in op.outputs.items())
            try:
                attrs = repr(attrs_fingerprint(op.attrs))
            except Unfingerprintable:
                attrs = repr(sorted((k, type(v).__name__)
                                    for k, v in op.attrs.items()))
            h.update(("o|%s|%s|%s|%s" % (op.type, ins, outs,
                                         attrs)).encode())
    return h.hexdigest()[:16]


def window_signature(program, feed: Dict[str, Any]) -> Tuple:
    """The tuner signature: (program fingerprint, one ``name:shape:
    dtype`` token per feed, sorted). A batch-size change or a different
    model re-tunes; a re-run of the same job serves the disk winner.
    Dtypes are CANONICALIZED as the JAX package's are (int64 -> int32,
    float64 -> float32, torch dtypes by their numpy names): resolution
    may see either the HOST feed (the executor-built prefetcher resolves
    from the raw batch) or the already-converted DEVICE feed (a
    caller-supplied prefetcher hands those over) — both must produce
    the signature the tuner persisted, or a tuned winner would be
    silently ignored on one path."""
    toks = []
    for n in sorted(feed or {}):
        v = feed[n]
        dt = v.dtype if hasattr(v, "dtype") else np.asarray(v).dtype
        toks.append("%s:%s:%s" % (n, tuple(np.shape(v)),
                                  _canonical_dtype(dt)))
    return (program_fingerprint(program),) + tuple(toks)


_CANONICAL = {"int64": "int32", "uint64": "uint32", "float64": "float32",
              "complex128": "complex64"}


def _canonical_dtype(dt) -> str:
    """A numpy or torch dtype by its numpy name, 64-bit types narrowed as
    the JAX package's default (x64 off) narrows them."""
    name = str(dt).replace("torch.", "")
    return _CANONICAL.get(name, name)


def window_candidates() -> List[int]:
    """Candidate window lengths — ``PADDLE_TPU_WINDOW_CANDIDATES``
    (comma-separated ints) overrides the {1,4,10,25,50} default; 1 (the
    composed per-step fallback) is always included."""
    raw = os.environ.get("PADDLE_TPU_WINDOW_CANDIDATES", "")
    if raw.strip():
        try:
            cands = sorted({max(1, int(t)) for t in raw.split(",")
                            if t.strip()})
        except ValueError:
            raise ValueError(
                "PADDLE_TPU_WINDOW_CANDIDATES must be comma-separated "
                "integers; got %r" % (raw,)) from None
    else:
        cands = sorted(set(DEFAULT_CANDIDATES))
    if 1 not in cands:
        cands.insert(0, 1)  # the mandatory composed fallback
    return cands


def tuned_window(program, feed: Dict[str, Any]) -> Optional[int]:
    """The tuned K for (program, feed), or None when no winner exists
    (or the kernel tier is bypassed — PADDLE_TPU_KERNELS=0 must move
    nothing, same contract as ``kernels.tuned_choice``). Counter-free:
    uses ``tune.peek``."""
    from .. import kernels
    from ..kernels import tune

    if not kernels.kernels_enabled():
        return None
    dec = tune.peek(WINDOW_OP, window_signature(program, feed))
    if dec is None:
        return None
    if dec.get("choice") == "cuda" and dec.get("cfg"):
        try:
            return max(1, int(dec["cfg"][0]))
        except (TypeError, ValueError):
            return None
    return 1


def env_steps_per_call() -> Optional[int]:
    """``PADDLE_TPU_STEPS_PER_CALL`` parsed and validated, or None when
    unset/empty. An invalid value fails loudly — same contract as the
    explicit argument, never a silent clamp to the per-step loop.
    ``run_pipelined`` calls this EAGERLY at call time so a bad env
    value raises before the generator exists, not from the prefetch
    fill thread at the first batch."""
    raw = os.environ.get("PADDLE_TPU_STEPS_PER_CALL", "").strip()
    if not raw:
        return None
    try:
        k = int(raw)
    except ValueError:
        raise ValueError(
            "PADDLE_TPU_STEPS_PER_CALL must be an integer; got %r"
            % (raw,)) from None
    if k < 1:
        raise ValueError(
            "PADDLE_TPU_STEPS_PER_CALL must be >= 1, got %d" % k)
    return k


def resolve_steps_per_call(program, feed: Dict[str, Any],
                           explicit: Optional[int] = None
                           ) -> Tuple[int, str]:
    """The windowed loop's K and where it came from: ``(K, source)``
    with source in {"arg", "env", "tuned", "default"}. Precedence:
    explicit argument > ``PADDLE_TPU_STEPS_PER_CALL`` > tuned
    ``train_window`` winner > 1."""
    if explicit is not None:
        k = int(explicit)
        if k < 1:
            raise ValueError("steps_per_call must be >= 1, got %d" % k)
        return k, "arg"
    k = env_steps_per_call()
    if k is not None:
        return k, "env"
    k = tuned_window(program, feed)
    if k is not None:
        return k, "tuned"
    return 1, "default"


def _copy(v):
    """A copy of a scope value. The RNG chain's generator is kept as it
    is: a step replaces it in the scope and never advances it
    (core/executor.py ``_chain``)."""
    return v.clone() if isinstance(v, torch.Tensor) else v


def _snapshot_state(plan, scope) -> Dict[str, Any]:
    """COPIES of every scope value a measured step can write (mut state,
    pure-written persistables, the RNG chain). Copies, not references:
    on the card a replay updates the scope's state tensors in place (K6
    writes params and moments over themselves), so a bare reference
    would hold the measured steps' values by restore time."""
    from .executor import RNG_VAR

    names = list(plan.mut_state) + list(plan.pure_written) + [RNG_VAR]
    out = {}
    for n in names:
        v = scope.find_var(n)
        out[n] = None if v is None else _copy(v)
    return out


def _restore_state(snap: Dict[str, Any], scope) -> None:
    """Reinstall the snapshot — as COPIES, so the held snapshot itself
    never enters the scope, where the next candidate's replay would
    update it in place. A replayed plan finds the replaced vars and
    copies them into its captured tensors (core/cuda_graph.py)."""
    for n, v in snap.items():
        if v is not None:
            scope.set_var(n, _copy(v))
        else:
            scope.erase(n)


def _stack_feed(feed: Dict[str, Any], k: int) -> Dict[str, Any]:
    """K copies of one real batch, stacked on the leading axis — the
    ``stack_feed_window`` layout with identical slices (measurement
    only cares about shapes/dispatch count, not data variety). A
    tensor feed (a captured function's, on its device) stacks where it
    lies."""
    return {n: torch.stack([v] * k) if isinstance(v, torch.Tensor)
            else np.stack([np.asarray(v)] * k) for n, v in feed.items()}


def _feed_batch_size(feed: Dict[str, Any]) -> int:
    """The feed's leading batch dim (1 when feedless) — what the
    memory pruner evaluates the batch polynomial at."""
    for v in (feed or {}).values():
        shape = np.shape(v)
        if shape:
            return max(1, int(shape[0]))
    return 1


def _memory_pruned(program, feed, fetch_list, scope, cands
                   ) -> Dict[int, int]:
    """Candidates whose PREDICTED peak exceeds the device budget
    (analysis/memory.py; silent without PADDLE_TPU_DEVICE_HBM_BYTES):
    {K: predicted bytes} for every over-budget K > 1 — pruned BEFORE
    measurement, so the tuner never pays a compile (or an OOM) for a
    window that provably cannot fit. K=1, the mandatory composed
    fallback, is never pruned. Counted per candidate in
    paddle_analysis_memory_pruned_total. An analysis failure prunes
    nothing — the measurement path is the ground truth either way."""
    from ..analysis.memory import MemoryAnalysis, device_budget
    from ..observe.families import ANALYSIS_MEMORY_PRUNED

    budget = device_budget()
    if budget is None or not any(k > 1 for k in cands):
        return {}
    try:
        fetch_names = [getattr(v, "name", str(v))
                       for v in (fetch_list or [])]
        ma = MemoryAnalysis(program, fetch_names=fetch_names,
                            scope=scope, site="window_tune")
        batch = _feed_batch_size(feed)
        pruned = {}
        for k in cands:
            if k <= 1:
                continue
            predicted = ma.peak_bytes(batch, steps_per_call=k)
            if predicted > budget:
                pruned[k] = predicted
                ANALYSIS_MEMORY_PRUNED.inc()
        return pruned
    except Exception:
        return {}


def tune_train_window(executor, program, feed: Dict[str, Any],
                      fetch_list: Optional[Sequence] = None,
                      scope=None, *, candidates: Optional[Sequence[int]]
                      = None, persist: bool = True,
                      cost_pruned: Optional[Dict[int, float]] = None
                      ) -> Dict[str, Any]:
    """Measure every candidate window length for (program, feed) on
    ``executor`` and install/persist the winner (module doc above).
    Returns the decision dict (``choice``/``cfg``/``seconds``/
    ``timings``). Scope state is bitwise restored — a tune right before
    training never perturbs it. Candidates whose statically predicted
    peak exceeds the device budget are skipped without measurement
    (``_memory_pruned``; their timings entries carry ``pruned: True``
    and ``seconds: None``). ``cost_pruned`` ({K: predicted seconds},
    from ``kernels.autotune``) records Ks the roofline already
    eliminated: they get the same pruned-entry treatment, with
    ``predicted_seconds`` instead of ``predicted_peak_bytes``, and are
    dropped from the measured set. K=1 is never prunable by either."""
    from ..kernels import tune
    from ..observe import trace as _tr
    from ..observe.families import KERNEL_TUNE_SECONDS, KERNEL_WINNERS
    from .scope import global_scope

    scope = scope if scope is not None else global_scope()
    cands = sorted({max(1, int(c)) for c in (
        candidates if candidates is not None else window_candidates())})
    if 1 not in cands:
        cands.insert(0, 1)
    sig = window_signature(program, feed)
    seed = tune.deterministic_seed()
    repeats = tune._repeats()
    t0 = time.perf_counter()
    cost_pruned = {int(k): float(s)
                   for k, s in (cost_pruned or {}).items() if int(k) > 1}
    with _tr.trace_span("kernel.tune", op=WINDOW_OP, sig=str(sig)):
        pruned = _memory_pruned(program, feed, fetch_list, scope, cands)
        plan = _plan_of(executor, program, feed, fetch_list, scope)
        snap = _snapshot_state(plan, scope)
        timings: List[Dict[str, Any]] = []
        measured: List[Tuple[float, int]] = []  # (seconds, timings idx)
        try:
            for k in cands:
                label = "composed" if k == 1 else "window:%d" % k
                entry: Dict[str, Any] = {
                    "label": label, "cfg": None if k == 1 else [k],
                    "choice": "composed" if k == 1 else "cuda"}
                if k in pruned:
                    entry.update(seconds=None, pruned=True,
                                 predicted_peak_bytes=int(pruned[k]))
                    timings.append(entry)
                    continue
                if k in cost_pruned:
                    entry.update(seconds=None, pruned=True,
                                 predicted_seconds=cost_pruned[k])
                    timings.append(entry)
                    continue
                if seed is not None:
                    secs = tune._fake_seconds(seed, WINDOW_OP, sig, label)
                else:
                    secs = _measure_candidate(executor, program, feed,
                                              fetch_list, scope, k,
                                              repeats)
                    _restore_state(snap, scope)
                entry["seconds"] = secs
                timings.append(entry)
                measured.append((secs, len(timings) - 1))
        finally:
            _restore_state(snap, scope)
        best = timings[min(measured)[1]]
        decision: Dict[str, Any] = {
            "choice": best["choice"], "cfg": best["cfg"],
            "seconds": best["seconds"], "source": "tuned",
            "timings": timings,
        }
        # the epoch bump: a window winner changes how the NEXT train loop
        # shapes its dispatches; graphs captured under the old table are
        # captured anew
        tune.set_entry(WINDOW_OP, sig, decision, persist=persist)
    KERNEL_TUNE_SECONDS.observe(time.perf_counter() - t0)
    KERNEL_WINNERS.labels(op=WINDOW_OP, choice=best["choice"]).inc()
    return decision


def _plan_of(executor, program, feed, fetch_list, scope):
    """The executor's plan ``run`` takes for this feed (prepared on a
    miss)."""
    program, scope, feeds, fetch_names = executor._args(
        program, feed, fetch_list, scope)
    return executor._plan(program, feeds, fetch_names, scope)


def _measure_candidate(executor, program, feed, fetch_list, scope,
                       k: int, repeats: int) -> float:
    """Best-of-``repeats`` per-step seconds of one candidate: K=1 times
    one ``run()`` step (the per-step path, its wait for the card
    included — exactly what a window amortizes); K>1 times one
    ``run_repeated`` window. Both are warmed first (twice: the eager
    step, then the capture) so a capture never lands in the
    measurement."""
    if k == 1:
        for _ in range(2):  # warmup: the eager step, then the capture
            executor.run(program, feed=feed, fetch_list=fetch_list,
                         scope=scope)

        def once() -> float:
            t0 = time.perf_counter()
            executor.run(program, feed=feed, fetch_list=fetch_list,
                         scope=scope)
            _block(executor)
            return time.perf_counter() - t0

        return min(once() for _ in range(repeats))
    stacked = _stack_feed(feed, k)
    for _ in range(2):
        executor.run_repeated(program, feed=stacked, fetch_list=fetch_list,
                              scope=scope, steps=k, feed_stacked=True)

    def once_k() -> float:
        t0 = time.perf_counter()
        executor.run_repeated(program, feed=stacked,
                              fetch_list=fetch_list, scope=scope,
                              steps=k, feed_stacked=True)
        _block(executor)
        return (time.perf_counter() - t0) / k

    return min(once_k() for _ in range(repeats))


def _block(executor) -> None:
    """Wait until the measured dispatch's device work is DONE (a replay
    is asynchronous: without it the timing would be the enqueue's)."""
    if executor.device.type == "cuda":
        torch.cuda.synchronize(executor.device)
