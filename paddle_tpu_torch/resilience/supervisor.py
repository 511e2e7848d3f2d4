"""Supervised training: periodic checkpoints, manifest, crash-resume.

The port of paddle_tpu/resilience/supervisor.py. It differs where the
device does:

* A restore puts every value on the device of the executor that
  resumes (``feed_to_device``: int64 narrowed to int32 as a feed is),
  never on the CPU for a card executor, and the RNG chain back into a
  ``torch.Generator``.
* A recovery releases the replaced executor's CUDA graphs and their
  memory pool before the fresh executor captures its own, and on the
  card hands the freed pool back (``torch.cuda.empty_cache``), so
  restarts do not each keep one more pool.
* A checkpoint's device-to-host snapshot is issued on the compute
  stream (``io._snapshot``), after every replay queued so far, so with
  steps in flight it still reads the state of the step it records.
* The ``@RNG_STATE@`` chain is the port's ``torch.Generator`` chain, not
  the JAX package's threefry key: a resumed run is bitwise within the
  port.

``resilient_train_loop`` wraps the executor's pipelined train loop with
the checkpoint-restart discipline production training systems assume:

* **Periodic async checkpoints** — every ``checkpoint_every`` dispatched
  steps, ``io.save_persistables_async`` snapshots the scope (device→host
  copy at call time, disk write in the background) into
  ``<checkpoint_dir>/step_NNNNNNNN/``, INCLUDING the executor's RNG
  chain (``@RNG_STATE@``), so a resumed run replays dropout masks
  bit-for-bit.
* **A manifest** — ``manifest.json`` at the checkpoint root is the
  atomic latest-pointer (tmp + ``os.replace``): it is only updated
  AFTER a checkpoint's background write is durably in place, records
  the exact resume position (global step, reader epoch, batch within
  the epoch, saved var names), and carries the retain-last-K list the
  pruner works from. A crash at ANY point leaves the manifest pointing
  at a complete, loadable checkpoint.
* **Recovery** — a retryable exception (``InjectedFault`` by default;
  pass e.g. ``RPCError`` for distributed runs) triggers: full-jitter
  backoff sleep → a FRESH ``Executor`` (plan cache and compiled state
  dropped — a wedge can leave them poisoned) → reload the latest
  manifest checkpoint into the scope → fast-forward the reader to the
  recorded batch → continue. With no durable checkpoint yet, the
  startup program re-runs instead (the RNG var is erased first so
  initializers re-seed identically).

**Determinism contract**: ``reader`` must be a zero-arg callable
returning a deterministic iterator of feed dicts (fresh per call/epoch).
Under that contract a run that crashes and resumes — in-process retry
or full process restart — produces params **bitwise identical** to an
uninterrupted run with the same seeds, because every replayed step sees
the same (state, RNG, batch) triple. ``on_step`` callbacks are
at-least-once: steps between the last checkpoint and a fault are
replayed after recovery.

See docs/RESILIENCE.md for the manifest format and the chaos-test
recipe; telemetry lands in the ``paddle_resilience_*`` families.
"""

from __future__ import annotations

import glob
import json
import os
import random
import shutil
import time
from collections import deque
from typing import Optional, Sequence

import torch

from .backoff import backoff_delay
from .faults import InjectedFault
from .watchdog import Watchdog

__all__ = ["resilient_train_loop", "SupervisorResult", "read_manifest",
           "write_manifest", "latest_checkpoint_dir", "MANIFEST_NAME"]

MANIFEST_NAME = "manifest.json"


# ----------------------------------------------------------- manifest
def read_manifest(checkpoint_dir: str) -> Optional[dict]:
    """The manifest dict, or None when no checkpoint was ever finalized
    (missing dir/file). A present-but-unparsable manifest raises — that
    is corruption to surface, not a fresh start to silently train over."""
    path = os.path.join(checkpoint_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_manifest(checkpoint_dir: str, man: dict) -> None:
    """Atomic manifest update (unique tmp + ``os.replace``): readers see
    the old pointer or the new one, never a torn file. Staging files
    orphaned by DEAD writer pids (a crash between write and rename —
    the same litter class the tensor-store cleaner collects for blobs)
    are removed first; live pids are never touched."""
    from ..native.tensor_store import _pid_alive

    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, MANIFEST_NAME)
    for stale in glob.glob(glob.escape(path) + ".tmp.*"):
        try:
            pid = int(stale.rsplit(".", 1)[-1])
        except ValueError:
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            try:
                os.remove(stale)
            except OSError:
                pass
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def latest_checkpoint_dir(checkpoint_dir: str) -> Optional[str]:
    """Absolute path of the manifest's latest checkpoint, or None."""
    man = read_manifest(checkpoint_dir)
    if man is None:
        return None
    return os.path.join(checkpoint_dir, man["latest"])


def _restore(checkpoint_dir: str, man: dict, scope, device) -> None:
    """Load every var the manifest recorded (params, optimizer slots,
    RNG chain) from its latest checkpoint into ``scope``, each value on
    ``device`` (the resuming executor's: the scope may be empty, so no
    value it replaces names a device)."""
    from ..core.executor import RNG_VAR, feed_to_device
    from ..core.place import require_device
    from ..io import _load_blob, _restored_chain

    require_device(device)
    path, data = _load_blob(os.path.join(checkpoint_dir, man["latest"]),
                            None)
    for n in man["var_names"]:
        try:
            val = data[n]
        except KeyError:
            raise RuntimeError(
                "checkpoint %s lacks manifest-recorded variable %r "
                "(manifest/checkpoint mismatch — was the directory "
                "hand-edited?)" % (path, n))
        if n == RNG_VAR:
            scope.set_var(n, _restored_chain(path, val))
        else:
            scope.set_var(n, feed_to_device(n, val, None, device))


class _Checkpointer:
    """Owns the async-save pipeline: at each boundary the PREVIOUS write
    is finalized (wait → manifest update → retain-last-K prune) and the
    next one launched, so disk writes overlap training and the manifest
    never points at an in-flight file."""

    def __init__(self, checkpoint_dir: str, keep_last: int,
                 on_written=None, manifest_extra=None):
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1, got %d" % keep_last)
        self.dir = checkpoint_dir
        self.keep_last = keep_last
        self._on_written = on_written  # called per finalized manifest
        # extra manifest payload (the elastic tier's `world` section):
        # a dict merged verbatim, or a callable(step, epoch,
        # batch_in_epoch) -> dict evaluated at each checkpoint
        self._manifest_extra = manifest_extra
        # the windowed loop's K: recorded in every manifest so a resume
        # (or a post-mortem) knows the dispatch shape checkpoints were
        # aligned to — every checkpointed step is a window boundary.
        # The supervisor learns it from the handles it resolves and
        # passes it per checkpoint() call
        self._steps_per_call = 1
        man = read_manifest(checkpoint_dir)
        self._retained = list(man["retained"]) if man else []
        self._pending = None  # (AsyncCheckpoint, manifest-entry meta)

    _RESERVED_KEYS = frozenset((
        "latest", "step", "epoch", "batch_in_epoch", "completed",
        "var_names", "version", "retained", "unix_time",
        "steps_per_call"))

    def _extra(self, step, epoch, batch_in_epoch) -> dict:
        extra = self._manifest_extra
        if extra is None:
            return {}
        if callable(extra):
            extra = extra(step, epoch, batch_in_epoch)
        bad = self._RESERVED_KEYS.intersection(extra or ())
        if bad:
            raise ValueError(
                "manifest_extra may not override reserved manifest "
                "keys %s" % sorted(bad))
        return dict(extra or {})

    def checkpoint(self, exe, program, scope, step: int, epoch: int,
                   batch_in_epoch: int, completed: bool = False,
                   steps_per_call: Optional[int] = None) -> None:
        if steps_per_call is not None:
            # the loop's RESOLVED window length, handle-reported
            self._steps_per_call = max(1, int(steps_per_call))
        from ..core.executor import RNG_VAR
        from ..io import _persistable_names, save_persistables_async
        from ..observe.families import RESILIENCE_CHECKPOINT_SECONDS

        t0 = time.perf_counter()
        self.finalize()
        names = _persistable_names(program, lambda v: v.persistable)
        if scope.find_var(RNG_VAR) is not None:
            names = names + [RNG_VAR]
        name = "step_%08d" % step
        handle = save_persistables_async(
            exe, os.path.join(self.dir, name), program, scope=scope,
            extra_vars=(RNG_VAR,))
        meta = {
            "latest": name, "step": step, "epoch": epoch,
            "batch_in_epoch": batch_in_epoch, "completed": completed,
            "var_names": names, "steps_per_call": self._steps_per_call,
        }
        meta.update(self._extra(step, epoch, batch_in_epoch))
        self._pending = (handle, meta)
        RESILIENCE_CHECKPOINT_SECONDS.observe(time.perf_counter() - t0)

    def finalize(self) -> None:
        """Wait for the in-flight write; on success update the manifest
        and prune, on failure count it and re-raise (the manifest keeps
        pointing at the previous good checkpoint)."""
        if self._pending is None:
            return
        from ..observe.families import RESILIENCE_CHECKPOINTS

        handle, meta = self._pending
        self._pending = None
        try:
            handle.wait()
        except BaseException:
            RESILIENCE_CHECKPOINTS.labels(status="failed").inc()
            raise
        self._retained = [d for d in self._retained
                          if d != meta["latest"]] + [meta["latest"]]
        keep = self._retained[-self.keep_last:]
        man = dict(meta)
        man.update(version=1, retained=keep, unix_time=time.time())
        write_manifest(self.dir, man)
        RESILIENCE_CHECKPOINTS.labels(status="written").inc()
        if self._on_written is not None:
            self._on_written()
        self._retained = keep
        self._prune(keep)

    def _prune(self, keep) -> None:
        """Remove every step_* dir NOT in the retained list — also
        self-heals dirs orphaned by a crash between manifest write and a
        previous prune, or by an abandoned in-flight checkpoint."""
        from ..observe.families import RESILIENCE_CHECKPOINTS

        try:
            entries = os.listdir(self.dir)
        except OSError:
            return
        live = set(keep)
        if self._pending is not None:
            live.add(self._pending[1]["latest"])
        for d in entries:
            if d.startswith("step_") and d not in live:
                shutil.rmtree(os.path.join(self.dir, d),
                              ignore_errors=True)
                RESILIENCE_CHECKPOINTS.labels(status="pruned").inc()

    def abandon(self) -> None:
        """Failure path: the in-flight write may still be a good EARLIER
        state — finalize it if it lands, swallow if it doesn't (the
        manifest then simply keeps its previous pointer)."""
        try:
            self.finalize()
        except BaseException:  # noqa: BLE001 — best-effort by contract
            pass


class SupervisorResult:
    """What ``resilient_train_loop`` hands back."""

    __slots__ = ("steps", "restarts", "resumed_from", "last", "wedges",
                 "recoveries")

    def __init__(self, steps=0, restarts=0, resumed_from=None, last=None,
                 wedges=0):
        self.steps = steps            # global steps at completion
        self.restarts = restarts      # in-call recoveries taken
        self.resumed_from = resumed_from  # manifest step on entry, or None
        self.last = last              # final step's fetch values
        self.wedges = wedges          # watchdog detections during the call
        # one dict per recovery taken, its host seconds by part: the
        # backoff sleep, the executor swap (the old one's graphs freed, a
        # fresh one made), the restore (manifest, values, resume
        # program), and the first and second dispatch after it (on the
        # card the plan's eager step and its capture; the first includes
        # waiting for the prefetcher's first batch). The port's addition.
        self.recoveries = []

    def __repr__(self):
        return ("SupervisorResult(steps=%d, restarts=%d, resumed_from=%r, "
                "wedges=%d)" % (self.steps, self.restarts,
                                self.resumed_from, self.wedges))


def resilient_train_loop(
    program,
    reader,
    fetch_list=None,
    scope=None,
    *,
    checkpoint_dir: str,
    startup_program=None,
    place=None,
    executor=None,
    checkpoint_every: int = 50,
    keep_last: int = 3,
    epochs: int = 1,
    max_restarts: int = 3,
    retryable: Optional[Sequence[type]] = None,
    backoff_base_s: float = 0.05,
    backoff_cap_s: float = 2.0,
    backoff_seed: Optional[int] = None,
    watchdog: Optional[Watchdog] = None,
    watchdog_deadline_s: Optional[float] = None,
    on_wedge=None,
    on_step=None,
    max_in_flight: int = 2,
    return_numpy: bool = True,
    resume: bool = True,
    manifest_extra=None,
    resume_program=None,
    steps_per_call: Optional[int] = None,
    reduce_fetches: str = "last",
) -> SupervisorResult:
    """Drive ``epochs`` passes of ``reader`` through the pipelined
    executor under checkpoint-restart supervision (module doc above).

    ``reader`` must be a zero-arg callable returning a fresh
    deterministic iterator of feed dicts — resume and multi-epoch both
    re-iterate it. ``on_step(global_step, values)`` fires per RESOLVED
    step in order (1-based, at-least-once across recoveries).
    ``watchdog_deadline_s`` arms a :class:`Watchdog` over the loop (or
    pass a constructed ``watchdog``); a wedge that surfaces as a
    retryable exception is then recovered like any transient fault.
    ``resume=False`` ignores an existing manifest (fresh run that will
    OVERWRITE it at the first checkpoint). ``checkpoint_every=0`` makes
    the loop READ-ONLY against ``checkpoint_dir``: it restores and
    fast-forwards from an existing manifest but never writes one — the
    mode an elastic job's non-zero ranks run in, sharing rank 0's
    manifest. ``manifest_extra`` (dict, or callable(step, epoch,
    batch_in_epoch) -> dict) merges extra sections into every written
    manifest (the elastic tier's ``world`` section rides this).
    ``resume_program`` runs right after ANY successful manifest restore
    (initial entry and in-call recovery) — e.g. re-publishing restored
    params to parameter servers before training resumes.

    **Windowed training** (``steps_per_call=K > 1``, or None to let the
    loop resolve env/tuned-winner/1 — see ``Executor.run_pipelined``):
    the loop dispatches one K-step scanned executable per window, and
    checkpoints land ONLY at window boundaries — at the first boundary
    at-or-after each ``checkpoint_every`` multiple — so the snapshot is
    always a fully-resolved post-step state and crash-resume stays
    bitwise. The manifest records ``steps_per_call``; a resumed run
    fast-forwards the reader to the recorded batch and starts a fresh
    window there (every checkpointed step IS a window edge, so windows
    re-align automatically; a resume may legally run a different K —
    the state/RNG advance is identical either way). ``on_step`` fires
    once per resolved WINDOW (global step of its last step, values per
    ``reduce_fetches``), still at-least-once across recoveries."""
    from ..core.executor import RNG_VAR, Executor
    from ..core.place import require_device
    from ..core.scope import global_scope
    from ..observe.families import (RESILIENCE_BACKOFF_SECONDS,
                                    RESILIENCE_RECOVERIES,
                                    RESILIENCE_RESTARTS, RESTART_CAUSES)

    if not callable(reader):
        raise TypeError(
            "resilient_train_loop needs reader to be a zero-arg callable "
            "returning a fresh iterator (resume and epochs re-iterate "
            "it); got %r" % type(reader).__name__)
    if checkpoint_every < 0:
        raise ValueError("checkpoint_every must be >= 0 (0 = read-only, "
                         "never checkpoint), got %d" % checkpoint_every)
    scope = scope if scope is not None else global_scope()
    if place is None and executor is not None:
        place = executor.place
    exe = executor if executor is not None else Executor(place)
    # a card run with no card raises here, before any manifest is read
    require_device(exe.device)
    rng = random.Random(backoff_seed)
    result = SupervisorResult()

    man = read_manifest(checkpoint_dir) if resume else None
    if man is not None:
        _restore(checkpoint_dir, man, scope, exe.device)
        if resume_program is not None:
            exe.run(resume_program, scope=scope)
        pos = (man["step"], man["epoch"], man["batch_in_epoch"])
        result.resumed_from = man["step"]
    else:
        if startup_program is not None:
            exe.run(startup_program, scope=scope)
        pos = (0, 0, 0)

    wd = watchdog
    if wd is None and watchdog_deadline_s is not None:
        wd = Watchdog(watchdog_deadline_s, on_wedge=on_wedge)
    started_wd = False
    if wd is not None and wd._thread is None:
        wd.start()
        started_wd = True

    if retryable is None:
        retryable = (InjectedFault,)
    retryable = tuple(retryable)
    # resume=False must hold through RECOVERY too, until this call has
    # finalized a manifest of its own — otherwise a fault before the
    # first own checkpoint would silently resume from a PREVIOUS run's
    # stale manifest sitting in the same directory
    own_manifest = [man is not None]

    def _recover(cause, parts):
        """Rebuild + reload; runs INSIDE the retried region so a
        transient fault during recovery itself (startup re-dispatch,
        checkpoint reload) consumes restart budget instead of escaping
        resilient_train_loop with budget unused. ``parts`` gets the
        swap's and the restore's seconds."""
        nonlocal exe, pos
        t0 = time.perf_counter()
        # a wedge can leave the executor's compiled state poisoned:
        # rebuild, don't reuse. The old executor's graphs and their pool
        # go first (the fault's traceback still references it)
        exe.release_plans()
        exe = Executor(exe.place)
        if exe.device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        parts["executor_s"] = t1 - t0
        man = read_manifest(checkpoint_dir) \
            if (resume or own_manifest[0]) else None
        if man is not None:
            _restore(checkpoint_dir, man, scope, exe.device)
            if resume_program is not None:
                exe.run(resume_program, scope=scope)
            pos = (man["step"], man["epoch"], man["batch_in_epoch"])
            RESILIENCE_RECOVERIES.labels(kind="resume").inc()
        else:
            if startup_program is None:
                raise RuntimeError(
                    "cannot recover: no checkpoint was finalized yet "
                    "and no startup_program was given to restart "
                    "from") from cause
            # erase the RNG chain so startup initializers re-seed from
            # the program seed, exactly like the first attempt
            scope.erase(RNG_VAR)
            exe.run(startup_program, scope=scope)
            pos = (0, 0, 0)
            RESILIENCE_RECOVERIES.labels(kind="restart").inc()
        parts["restore_s"] = time.perf_counter() - t1

    try:
        fault = None
        while True:
            marks = parts = None
            try:
                if fault is not None:
                    parts = result.recoveries[-1]
                    _recover(fault, parts)
                    fault = None
                    marks = [time.perf_counter()]
                last, steps = _attempt(
                    exe, program, reader, fetch_list, scope, pos, epochs,
                    checkpoint_every, keep_last, checkpoint_dir, on_step,
                    max_in_flight, return_numpy,
                    lambda: own_manifest.__setitem__(0, True),
                    manifest_extra, steps_per_call, reduce_fetches, marks)
                result.last, result.steps = last, steps
                break
            except retryable as e:
                result.restarts += 1
                # the cause was previously only visible in the flight
                # recorder; the counter makes the restart RATE and its
                # dominant exception class a dashboard quantity
                cause = type(e).__name__
                if cause not in RESTART_CAUSES:
                    cause = "other"
                RESILIENCE_RESTARTS.labels(cause=cause).inc()
                if result.restarts > max_restarts:
                    raise
                delay = backoff_delay(result.restarts - 1, backoff_base_s,
                                      backoff_cap_s, rng)
                RESILIENCE_BACKOFF_SECONDS.observe(delay)
                time.sleep(delay)
                result.recoveries.append(dict(cause=type(e).__name__,
                                              backoff_s=delay))
                fault = e
            finally:
                if marks is not None and len(marks) > 1:
                    parts.update(
                        (k, b - a) for k, a, b in zip(
                            ("first_dispatch_s", "second_dispatch_s"),
                            marks, marks[1:]))
    finally:
        if started_wd:
            wd.stop()
    if wd is not None:
        result.wedges = len(wd.wedges)
    return result


def _attempt(exe, program, reader, fetch_list, scope, pos, epochs,
             checkpoint_every, keep_last, checkpoint_dir, on_step,
             max_in_flight, return_numpy, on_written=None,
             manifest_extra=None, steps_per_call=None,
             reduce_fetches="last", marks=None):
    """One uninterrupted run from ``pos`` to the end of the last epoch.
    Raises on the first fault; the caller decides whether to recover.
    ``marks``, a list holding a start time, gets the time after each of
    the first two dispatches.
    ``checkpoint_every=0``: read-only — no checkpointer is even built,
    so the shared manifest dir is never written."""
    from ..observe.families import RESILIENCE_FF_BATCHES

    step, e0, b0 = pos
    ck = _Checkpointer(checkpoint_dir, keep_last, on_written=on_written,
                       manifest_extra=manifest_extra) \
        if checkpoint_every else None
    pending = deque()
    last = [None]
    cur_k = [1]  # the loop's resolved window width (handle-reported)

    def resolve(entry):
        gstep, h = entry
        vals = h.result()
        last[0] = vals
        if on_step is not None:
            on_step(gstep, vals)

    try:
        for epoch in range(e0, epochs):
            skip = b0 if epoch == e0 else 0

            def ff_reader(skip=skip):
                it = reader()
                for i, feed in enumerate(it):
                    if i < skip:
                        # consumed and discarded: the reader replays the
                        # epoch from the top; state for these steps
                        # comes from the checkpoint
                        RESILIENCE_FF_BATCHES.inc()
                        continue
                    yield feed

            batch_in_epoch = skip
            for h in exe.run_pipelined(
                    program, ff_reader, fetch_list, scope,
                    max_in_flight=max_in_flight,
                    return_numpy=return_numpy,
                    steps_per_call=steps_per_call,
                    reduce_fetches=reduce_fetches):
                if marks is not None and len(marks) < 3:
                    marks.append(time.perf_counter())
                prev = step
                step += h.steps
                batch_in_epoch += h.steps
                # the handle reports the loop's RESOLVED K, not this
                # dispatch's step count — an all-ragged run (reader ran
                # dry before filling a window) still records the K the
                # loop resolved, and a max over h.steps could never
                # have seen it
                cur_k[0] = h.window
                pending.append((step, h))
                if len(pending) > max_in_flight:
                    resolve(pending.popleft())
                if ck is not None and \
                        step // checkpoint_every > prev // checkpoint_every:
                    # checkpoints land only at WINDOW boundaries: the
                    # first boundary at-or-after each checkpoint_every
                    # multiple (for K=1 this is exactly the old
                    # `step % checkpoint_every == 0`). A window is one
                    # indivisible dispatch — there is no consistent
                    # mid-window state to snapshot.
                    # drain BEFORE checkpointing: once this manifest is
                    # finalized, a later fault resumes past these steps
                    # and a handle still pending here would never get
                    # its on_step — in this run or any replay (the
                    # at-least-once contract). The checkpoint blocks on
                    # this step's device state anyway, so resolving the
                    # window first costs no extra stall
                    while pending:
                        resolve(pending.popleft())
                    # the generator is suspended right after dispatching
                    # the window ending at `step` (state written back,
                    # next window not yet dispatched): the snapshot is
                    # exactly post-step state at a window edge
                    ck.checkpoint(exe, program, scope, step, epoch,
                                  batch_in_epoch,
                                  steps_per_call=cur_k[0])
        while pending:
            resolve(pending.popleft())
        # final checkpoint: epoch == epochs / batch 0 means "nothing left
        # to replay" — resuming a completed run restores state and
        # trains zero further steps
        if ck is not None:
            ck.checkpoint(exe, program, scope, step, epochs, 0,
                          completed=True, steps_per_call=cur_k[0])
            ck.finalize()
        return last[0], step
    except BaseException:
        # in-flight fetch handles are dropped (their steps replay after
        # recovery); an in-flight checkpoint of an EARLIER step is still
        # worth finalizing — best-effort, never masks the real fault
        if ck is not None:
            ck.abandon()
        raise
