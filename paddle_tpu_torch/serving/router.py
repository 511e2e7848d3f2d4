"""SLO-aware multi-replica routing with supervised replica health.

One :class:`DecodeEngine` is one process-local serving unit; "millions
of users" need N of them behind one front door. The router owns that
tier, reusing the queue layer's semantics end to end:

* **Admission** — per-tenant in-flight quotas and SLO-aware
  reject-early: when the projected queue wait (outstanding tokens on
  the least-loaded replica / the measured token rate) already exceeds
  a request's deadline, the caller hears no AT SUBMIT instead of after
  the deadline burned in a queue — the same never-spend-compute-on-a-
  dead-answer contract as ``RequestQueue``'s pop-time expiry, moved one
  hop earlier. Replica queues keep their own backpressure; a request
  bounced by every healthy replica is rejected, never silently dropped.
* **Routing** — least-outstanding-tokens across healthy replicas; the
  logical request keeps ONE reporting identity (trace, tenant-labelled
  ``paddle_serving_requests_total`` outcome) while per-replica attempts
  ride as non-reporting internal requests, so the exactly-once
  terminal-outcome invariant holds at the caller's layer no matter how
  many replicas a request visits.
* **Supervision** — a monitor thread (nudged by the watchdog's wedge
  callback when one is attached) sweeps replica health: a dead
  scheduler (crashed on an injected fault) or a wedged one (active
  slots, stale progress stamp) is DRAINED — ``engine.stop`` with a
  short join fails its in-flight work, whose completion callbacks
  re-admit every affected request onto surviving replicas — and
  restarted through the caller's engine factory. Re-admitted requests
  restart generation from the prompt (seeded sampling: outputs are
  unaffected).

Replicas built from one model config may share one
:class:`~paddle_tpu_torch.serving.prefix.PrefixStore`: a prefix prefilled on
any replica hits on all of them (the router passes the shared store to
its factory calls when given one).

Telemetry: ``paddle_serving_router_*`` (docs/SERVING.md has the table);
trace events ``serving.router.route`` / ``drain`` / ``readmit`` ride
each request's one trace across the hop.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..observe import trace as _tr
from ..observe.timeseries import Ewma
from .queue import Cancelled, DeadlineExpired, QueueFull, ServingRequest

__all__ = ["ReplicaRouter", "TenantQuotaExceeded"]


class TenantQuotaExceeded(QueueFull):
    """The tenant's in-flight quota is exhausted (router admission)."""


class _Replica:
    """One supervised engine slot (stable index across restarts)."""

    __slots__ = ("idx", "engine", "outstanding_tokens", "draining",
                 "restarts")

    def __init__(self, idx, engine):
        self.idx = idx
        self.engine = engine
        self.outstanding_tokens = 0
        self.draining = False
        self.restarts = 0


class ReplicaRouter:
    """Spread generation requests over N in-process engine replicas.

    ``engine_factory(replica_idx)`` builds (and does NOT start) one
    ``DecodeEngine``; the router starts it, supervises it, and calls
    the factory again after a drain. All replicas must serve the same
    model (same params/config) — routing assumes any replica can serve
    any request.

    * ``tenant_quotas`` maps tenant id -> max in-flight requests
      (``default_quota`` caps unlisted tenants; None = unlimited).
    * ``service_rate_tps`` seeds the per-stream token-rate estimate the
      SLO projection divides by; completions refine it by EWMA. With no
      seed and no completions yet, the SLO check admits (no basis to
      reject).
    * ``stall_deadline_s`` arms wedge detection: a replica with active
      slots whose scheduler hasn't stamped progress within the deadline
      is drained and restarted. ``max_readmissions`` bounds how many
      replica failures one request may ride out before its caller sees
      the error.
    """

    def __init__(self, engine_factory: Callable[[int], object],
                 n_replicas: int = 2, *,
                 tenant_quotas: Optional[Dict[str, int]] = None,
                 default_quota: Optional[int] = None,
                 service_rate_tps: Optional[float] = None,
                 max_readmissions: int = 2,
                 stall_deadline_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 autostart: bool = True):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._factory = engine_factory
        self._tenant_quotas = dict(tenant_quotas or {})
        self._default_quota = default_quota
        # the shared smoothing implementation (observe/timeseries.py):
        # the fleet plane reads rates with the identical arithmetic
        self._rate = Ewma(alpha=0.2,
                          initial=(float(service_rate_tps)
                                   if service_rate_tps else None))
        self._max_readmissions = int(max_readmissions)
        self._stall_deadline_s = stall_deadline_s
        self._poll_s = float(poll_s)
        self._lock = threading.Lock()
        self._tenant_inflight: Dict[str, int] = {}
        # logical request -> (replica, inner attempt, attempts used)
        self._inflight: Dict[ServingRequest, tuple] = {}
        self._replicas = [_Replica(i, engine_factory(i))
                          for i in range(n_replicas)]
        for r in self._replicas:
            r.engine.start()
        self._closed = False
        self._nudge = threading.Event()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="ReplicaRouter",
                                         daemon=True)
        self._started = False
        self._set_healthy_gauge()
        if autostart:
            self.start()

    # ------------------------------------------------------------ caller
    def submit(self, prompt_ids, n_new: int, *, tenant: str = "default",
               deadline_s: Optional[float] = None, **gen_kwargs
               ) -> ServingRequest:
        """Admit one generation request to the fleet. Returns the ONE
        reporting future; raises ``TenantQuotaExceeded`` /
        ``DeadlineExpired`` (SLO reject-early) / ``QueueFull`` (all
        healthy replicas backpressured) — each rejection is also the
        request's counted terminal outcome. ``gen_kwargs`` pass through
        to ``DecodeEngine.submit`` (eos_id, temperature, top_k, seed,
        prefix_len)."""
        from ..observe.families import (SERVING_ROUTER_PROJECTED_WAIT,
                                        SERVING_ROUTER_REJECTED)

        if self._closed:
            raise RuntimeError("ReplicaRouter is closed")
        payload = dict(prompt_ids=np.asarray(prompt_ids,
                                             dtype="int64").reshape(-1),
                       n_new=int(n_new), **gen_kwargs)
        # the logical request: mints THE trace, carries the tenant,
        # reports the one terminal outcome
        req = ServingRequest(payload, deadline_s=deadline_s,
                             tenant=tenant)
        quota = self._tenant_quotas.get(tenant, self._default_quota)
        with self._lock:
            held = self._tenant_inflight.get(tenant, 0)
            if quota is not None and held >= quota:
                SERVING_ROUTER_REJECTED.labels(reason="quota").inc()
                exc = TenantQuotaExceeded(
                    "tenant %r holds %d in-flight requests (quota %d)"
                    % (tenant, held, quota))
                req._reject(exc)
                raise exc
            self._tenant_inflight[tenant] = held + 1
        req.add_done_callback(self._release_tenant)
        # SLO reject-early: if even the least-loaded replica's backlog
        # projects past the deadline, say no now
        if deadline_s is not None:
            projected = self._projected_wait()
            if projected is not None:
                SERVING_ROUTER_PROJECTED_WAIT.observe(projected)
                if projected > deadline_s:
                    SERVING_ROUTER_REJECTED.labels(reason="slo").inc()
                    exc = DeadlineExpired(
                        "projected queue wait %.3fs exceeds the %.3fs "
                        "deadline — rejected at admission" %
                        (projected, deadline_s))
                    req._reject(exc)
                    raise exc
        try:
            self._dispatch(req, exclude=(), attempts=0)
        except BaseException as exc:  # noqa: BLE001 — reject, don't strand
            req._reject(exc)
            raise
        return req

    def start(self) -> "ReplicaRouter":
        if not self._started:
            self._started = True
            self._monitor.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop supervision and every replica. In-flight requests fail
        with ``Cancelled`` (no re-admission during shutdown)."""
        with self._lock:
            # under the lock so a concurrent _recover either observes
            # the close before installing its replacement engine, or
            # installs first and the replica sweep below stops it
            self._closed = True
        self._nudge.set()
        if self._started:
            self._monitor.join(timeout=timeout)
        for r in self._replicas:
            r.engine.stop(timeout=timeout)
        self._set_healthy_gauge()

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def replicas(self):
        return list(self._replicas)

    def on_wedge(self, event=None) -> None:
        """Watchdog hook: pass as ``Watchdog(on_wedge=router.on_wedge)``
        to trigger an immediate health sweep when the heartbeat
        watchdog fires, instead of waiting out the poll interval."""
        self._nudge.set()

    def on_breach(self, breach=None) -> None:
        """SLO-monitor hook: pass as
        ``SloMonitor(...).subscribe(router.on_breach)`` (observe/slo.py)
        to trigger an immediate health sweep when an objective breaches
        — a latency SLO burning is often a replica wedging, and the
        sweep is the router's cheapest diagnostic."""
        self._nudge.set()

    def set_stall_deadline(self, seconds: Optional[float]) -> None:
        """(Re)arm wedge detection at a new deadline; ``None`` disarms.
        The monitor reads the deadline on every poll, so this takes
        effect immediately — the knob for arming detection only AFTER
        warmup with a deadline CALIBRATED from measured healthy request
        latency (a fixed deadline chosen before the box's real speed is
        known either misses wedges or drains healthy-but-slow replicas;
        the chaos tests use exactly this pattern)."""
        if seconds is not None and seconds <= 0:
            raise ValueError("stall deadline must be > 0 or None, got %r"
                             % (seconds,))
        self._stall_deadline_s = seconds

    # ------------------------------------------------------------- roll
    def roll(self, artifact, engine_factory=None, **engine_kwargs) -> int:
        """Rolling fleet upgrade: replace every replica, one at a time
        with drain, with engines built from ``artifact`` (a path or a
        ``LoadedArtifact``) — the fleet moves from artifact v(N) to
        v(N+1) with zero stranded requests.

        The artifact is loaded + VALIDATED first: a skewed or corrupt
        artifact raises ``ArtifactSkewError`` before any replica is
        touched and the fleet keeps serving the old version. The
        router's engine factory is swapped to the new version BEFORE
        the first drain, so a replica that crashes mid-roll is rebuilt
        by the ordinary monitor path already at the new version (the
        chaos test pins this). Each replica then drains through the
        same ``_recover`` machinery a died/wedged replica uses —
        in-flight requests re-admit onto the other replicas and keep
        their exactly-once terminal outcome.

        ``engine_factory`` overrides the default
        ``DecodeEngine.from_artifact`` builder (``engine_kwargs`` pass
        through to it). Returns the number of replicas rolled; counted
        in ``paddle_export_roll_replicas_total`` and
        ``paddle_export_rolls_total{outcome=ok|partial}``."""
        from ..observe.families import (ARTIFACT_ROLL_REPLICAS,
                                        ARTIFACT_ROLLS)

        if self._closed:
            raise RuntimeError("ReplicaRouter is closed")
        if engine_factory is None:
            from ..export import LoadedArtifact, load_artifact
            from .engine import DecodeEngine

            art = (artifact if isinstance(artifact, LoadedArtifact)
                   else load_artifact(artifact))

            def engine_factory(idx, _art=art, _kw=dict(engine_kwargs)):
                return DecodeEngine.from_artifact(_art, **_kw)

        self._factory = engine_factory
        rolled = 0
        for rep in list(self._replicas):
            if self._closed:
                break
            if self._recover(rep, "roll"):
                rolled += 1
                ARTIFACT_ROLL_REPLICAS.inc()
            elif rep.draining and not self._closed:
                # the monitor claimed this replica first (it died or
                # wedged mid-roll) — it is rebuilding through the
                # factory we already swapped, i.e. at the NEW version;
                # wait for that rebuild rather than double-draining
                while rep.draining and not self._closed:
                    time.sleep(self._poll_s)
                if not self._closed:
                    rolled += 1
                    ARTIFACT_ROLL_REPLICAS.inc()
        outcome = ("ok" if rolled == len(self._replicas)
                   and not self._closed else "partial")
        ARTIFACT_ROLLS.labels(outcome=outcome).inc()
        return rolled

    # ---------------------------------------------------------- dispatch
    def _healthy(self, exclude=()):
        return [r for r in self._replicas
                if r.engine.alive() and not r.draining
                and r.idx not in exclude]

    def _projected_wait(self) -> Optional[float]:
        rate = self._rate.value
        if rate is None or rate <= 0:
            return None
        cands = self._healthy()
        if not cands:
            return None
        best = min(cands, key=lambda r: r.outstanding_tokens)
        # per-stream rate x slot count = the replica's aggregate
        # throughput; coarse by design (documented in SERVING.md)
        agg = rate * max(getattr(best.engine, "b_max", 1), 1)
        return best.outstanding_tokens / agg

    def _dispatch(self, req: ServingRequest, exclude, attempts) -> None:
        """Forward the logical request to the least-loaded healthy
        replica as a non-reporting internal attempt; try the next one
        on backpressure. Raises when every candidate refused."""
        from ..observe.families import SERVING_ROUTER_ROUTED

        p = req.payload
        last_exc: Optional[BaseException] = None
        remaining = (None if req.deadline is None
                     else max(req.deadline - time.monotonic(), 0.0))
        for rep in sorted(self._healthy(exclude),
                          key=lambda r: r.outstanding_tokens):
            engine = rep.engine
            try:
                inner = engine.submit(
                    p["prompt_ids"], p["n_new"],
                    deadline_s=remaining, tenant=req.tenant,
                    trace_ctx=req.trace, report=False,
                    **{k: v for k, v in p.items()
                       if k not in ("prompt_ids", "n_new")})
            except (QueueFull, RuntimeError) as exc:
                # full queue or a replica that died under us: next
                last_exc = exc
                continue
            with self._lock:
                # the attempt remembers ITS engine: after a drain the
                # replica slot holds a fresh one, and an old attempt
                # surfacing a late error must read as replica failure
                self._inflight[req] = (rep, inner, attempts + 1, engine)
                rep.outstanding_tokens += p["n_new"]
            SERVING_ROUTER_ROUTED.labels(replica=str(rep.idx)).inc()
            if req.trace is not None:
                _tr.trace_event("serving.router.route", ctx=req.trace,
                                replica=rep.idx,
                                outstanding=rep.outstanding_tokens)
            inner.add_done_callback(
                lambda _inner, req=req: self._on_attempt_done(req))
            return
        from ..observe.families import SERVING_ROUTER_REJECTED
        from .engine import MemoryBudgetExceeded

        # a memory-guard refusal is its own admission story (the fleet
        # provably cannot hold the prompt's prefill, more replicas of
        # the same shape won't help) — count it apart from transient
        # queue backpressure
        reason = ("memory" if isinstance(last_exc, MemoryBudgetExceeded)
                  else "backpressure")
        SERVING_ROUTER_REJECTED.labels(reason=reason).inc()
        raise last_exc if last_exc is not None else QueueFull(
            "no healthy replica accepted the request")

    def _on_attempt_done(self, req: ServingRequest) -> None:
        """Completion forwarding + re-admission, run on whichever
        thread finished the attempt (engine scheduler, drain)."""
        from ..observe.families import SERVING_ROUTER_READMITTED

        with self._lock:
            entry = self._inflight.pop(req, None)
            if entry is None:
                return
            rep, inner, attempts, engine = entry
            rep.outstanding_tokens = max(
                0, rep.outstanding_tokens - req.payload["n_new"])
        # read the attempt's terminal state directly: done-callbacks run
        # BEFORE the event result()/exception() wait on, by design
        # (queue.ServingRequest._finish)
        exc = inner._exc
        if exc is None:
            req.set_result(inner._value)
            self._observe_rate(req)
            return
        if req.done():
            return  # caller already cancelled the logical request
        replica_failed = (rep.draining or engine is not rep.engine
                          or not rep.engine.alive()
                          or isinstance(exc, Cancelled))
        if (replica_failed and not self._closed
                and not isinstance(exc, DeadlineExpired)
                and attempts <= self._max_readmissions):
            SERVING_ROUTER_READMITTED.inc()
            if req.trace is not None:
                _tr.trace_event("serving.router.readmit", ctx=req.trace,
                                from_replica=rep.idx, attempt=attempts)
            try:
                self._dispatch(req, exclude=(rep.idx,),
                               attempts=attempts)
                return
            except BaseException as exc2:  # noqa: BLE001 — nowhere left to go
                exc = exc2
        req.set_exception(exc)

    def _release_tenant(self, req: ServingRequest) -> None:
        with self._lock:
            held = self._tenant_inflight.get(req.tenant, 1)
            self._tenant_inflight[req.tenant] = max(0, held - 1)

    def _observe_rate(self, req: ServingRequest) -> None:
        dt = time.monotonic() - req.submitted_at
        if dt <= 0:
            return
        inst = req.payload["n_new"] / dt
        # EWMA refinement of the per-stream token rate the SLO
        # projection divides by (inst includes queue wait — a loaded
        # fleet projects pessimistically, which is the safe direction)
        self._rate.update(inst)

    # --------------------------------------------------------- monitoring
    def _monitor_loop(self) -> None:
        while not self._closed:
            self._nudge.wait(self._poll_s)
            self._nudge.clear()
            if self._closed:
                return
            for rep in self._replicas:
                if rep.draining:
                    continue
                eng = rep.engine
                dead = eng._started and not eng.alive()
                stalled = False
                if self._stall_deadline_s is not None \
                        and eng._n_active > 0:
                    age = time.monotonic() - eng.last_progress
                    # the Watchdog's wedge-vs-slow-compile distinction,
                    # replica-local: while the scheduler sits inside
                    # compiling-class work (admission program builds,
                    # first-signature dispatches, splice jits — the
                    # engine marks them) a stale stamp is judged
                    # against the 10x compile grace, not the stall
                    # deadline
                    limit = self._stall_deadline_s
                    if eng.busy_compiling():
                        limit = max(10.0 * limit, 30.0)
                    stalled = age > limit
                if dead or stalled:
                    self._recover(rep,
                                  "died" if dead else "wedged")

    def _recover(self, rep: _Replica, reason: str) -> bool:
        """Drain a failed replica and rebuild it. ``engine.stop`` with
        a short join fails every in-flight request (a truly wedged
        scheduler thread is abandoned — daemon) and their completion
        callbacks re-admit them elsewhere; queued requests cancel via
        the queue close inside stop and re-admit the same way.

        Recovery runs ON the monitor thread, serially: while one
        replica rebuilds (an engine build can compile for seconds), a
        second correlated failure waits its turn — the drain of the
        FIRST replica already re-homed its requests, so the cost is
        detection latency, not stranded work. ``close()`` racing a
        rebuild is handled by re-checking ``_closed`` around the
        factory call: a replacement engine is never installed (or left
        running) after shutdown.

        Returns True when this call installed the replacement. The
        draining flag is claimed under the lock so a second caller
        (``roll`` runs on the caller's thread while the monitor keeps
        sweeping) backs off instead of double-draining one replica."""
        from ..observe.families import SERVING_ROUTER_RESTARTS

        with self._lock:
            if rep.draining:
                return False
            rep.draining = True
        self._set_healthy_gauge()
        with _tr.trace_span("serving.router.drain", replica=rep.idx,
                            reason=reason):
            rep.engine.stop(timeout=0.5)
            if self._closed:
                return False  # close() owns the teardown from here
            eng = self._factory(rep.idx)
            with self._lock:
                install = not self._closed
                if install:
                    rep.engine = eng
            if not install:
                eng.stop(timeout=0.5)
                return False
            eng.start()
        with self._lock:
            rep.outstanding_tokens = 0
        rep.restarts += 1
        rep.draining = False
        SERVING_ROUTER_RESTARTS.labels(replica=str(rep.idx)).inc()
        self._set_healthy_gauge()
        return True

    def _set_healthy_gauge(self) -> None:
        from ..observe.families import SERVING_ROUTER_HEALTHY

        SERVING_ROUTER_HEALTHY.set(sum(
            1 for r in self._replicas
            if not self._closed and r.engine.alive() and not r.draining))
