"""Trainer membership for elastic jobs: heartbeat leases + reshard math.

The elastic tier's (resilience/elastic.py) answer to "who is in the
job RIGHT NOW": a heartbeat-stamped trainer registry with lease expiry,
maintained THROUGH the RPC server — trainers push heartbeats over the
ordinary ``RPCClient.send_var`` wire to an async-mode :class:`RPCServer`
owned by the job supervisor, and :meth:`MembershipServer.active_trainers`
extends the native transport's ``RPCServer.active_trainers`` connection
count with lease semantics (a SIGKILLed trainer's TCP socket can linger;
its lease cannot).

Three pieces:

* :class:`MembershipView` — the registry itself. Thread-safe dict of
  ``trainer id -> lease``; the first heartbeat of an unknown trainer is
  a **join**, a heartbeat from a previously evicted/left trainer is a
  **rejoin**, ``leave()`` is the graceful goodbye, and ``sweep()``
  expires leases into **evict** events. Every transition counts into
  ``paddle_elastic_membership_events_total{event}`` and emits an
  ``elastic.membership`` trace event, so a chaos test asserts the story
  on telemetry. Join/rejoin processing passes the ``membership.join``
  fault site: an armed ``raise`` there simulates a partitioned join
  (the announcement is dropped and counted; the trainer's next
  heartbeat retries).
* :class:`MembershipServer` / :class:`HeartbeatSender` — the transport.
  Heartbeats ride ``send_var("@ELASTIC_HB@", [tid, generation, step])``
  into the async queue (no barrier interference with any data-plane
  pserver); the sender side stamps the ``trainer.heartbeat`` fault site
  (one occurrence at join, then one per resolved step — ``crash`` at
  occurrence ``s+1`` is THE deterministic way to kill trainer k at
  step s).
* **Reshard math** — pure functions of ``(manifest, new_world)``:
  :func:`shard_assignment` deals the job's fixed data shards round-robin
  over the SORTED surviving trainer ids, :func:`make_world` /
  :func:`reshard` build the manifest ``world`` section, and
  :func:`world_from_manifest` loads it with forward/backward
  compatibility (a pre-elastic manifest = a single-trainer world; a
  malformed section degrades to fresh-start with a counted warning,
  never a crash). Determinism of the whole elastic job reduces to these
  being pure: two jobs handed the same (manifest, world) compute the
  same shard assignment, read the same batches, and — with the PS
  aggregating in trainer-id order — the same bits.

See docs/RESILIENCE.md "Elastic jobs" for the membership grammar and
lease/eviction policy.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..observe import trace as _tr
from ..observe.families import (ELASTIC_EVENTS, ELASTIC_HEARTBEATS,
                                ELASTIC_JOINS_DROPPED,
                                ELASTIC_TRAINERS_ACTIVE,
                                ELASTIC_WORLD_FALLBACKS)
from ..resilience.faults import InjectedFault, fault_point

__all__ = ["MembershipView", "MembershipServer", "HeartbeatSender",
           "TrainerLease", "shard_assignment", "make_world", "reshard",
           "world_from_manifest", "HB_VAR", "LEAVE_VAR"]

# membership wire vocabulary: reserved var names on the membership
# endpoint (the @...@ convention of RNG_STATE/SEND_BARRIER — never
# legal model var names)
HB_VAR = "@ELASTIC_HB@"
LEAVE_VAR = "@ELASTIC_LEAVE@"

WORLD_VERSION = 1


class TrainerLease:
    """One trainer's registry entry."""

    __slots__ = ("tid", "last_beat", "joined_at", "beats", "step",
                 "generation", "alive")

    def __init__(self, tid: int, now: float):
        self.tid = tid
        self.last_beat = now
        self.joined_at = now
        self.beats = 0
        self.step = -1          # last step the trainer reported
        self.generation = -1    # generation it reported from
        self.alive = True

    def __repr__(self):
        return ("TrainerLease(tid=%d, alive=%s, step=%d, beats=%d)"
                % (self.tid, self.alive, self.step, self.beats))


class MembershipView:
    """Heartbeat-stamped trainer registry with lease expiry.

    ``on_event(event, tid, **info)`` (optional) receives every
    transition — the elastic supervisor uses it to build the job's
    timeline. ``clock`` is injectable for deterministic tests."""

    def __init__(self, lease_s: float = 10.0,
                 on_event: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        if lease_s <= 0:
            raise ValueError("lease_s must be > 0, got %r" % lease_s)
        self.lease_s = lease_s
        self._on_event = on_event
        self._clock = clock
        self._lock = threading.Lock()
        self._leases: Dict[int, TrainerLease] = {}
        self._version = 0  # bumps on every membership CHANGE

    # ------------------------------------------------------------ events
    def _emit(self, event: str, tid: int, **info) -> None:
        ELASTIC_EVENTS.labels(event=event).inc()
        if _tr.trace_enabled():
            _tr.trace_event("elastic.membership", event=event,
                            trainer=tid, **info)
        if self._on_event is not None:
            self._on_event(event, tid, **info)

    def _set_active_gauge_locked(self) -> None:
        ELASTIC_TRAINERS_ACTIVE.set(
            sum(1 for l in self._leases.values() if l.alive))

    # ------------------------------------------------------------- beats
    def heartbeat(self, tid: int, step: int = -1,
                  generation: int = -1) -> Optional[str]:
        """Stamp trainer ``tid``'s lease; returns the membership event
        this beat caused ("join", "rejoin") or None for a routine beat.
        A join/rejoin dropped by an armed ``membership.join`` fault
        returns None and leaves the trainer unknown — its next beat
        retries the announcement."""
        tid = int(tid)
        now = self._clock()
        with self._lock:
            lease = self._leases.get(tid)
            event = None
            if lease is None:
                event = "join"
            elif not lease.alive:
                event = "rejoin"
            if event is not None:
                try:
                    fault_point("membership.join")
                except InjectedFault:
                    ELASTIC_JOINS_DROPPED.inc()
                    return None
                if lease is None:
                    lease = self._leases[tid] = TrainerLease(tid, now)
                lease.alive = True
                lease.joined_at = now
                self._version += 1
            lease.last_beat = now
            lease.beats += 1
            if step >= 0:
                lease.step = int(step)
            if generation >= 0:
                lease.generation = int(generation)
            self._set_active_gauge_locked()
        ELASTIC_HEARTBEATS.inc()
        if event is not None:
            self._emit(event, tid, step=int(step),
                       generation=int(generation))
        return event

    def touch(self, tid: int) -> None:
        """Re-stamp a KNOWN live trainer's lease without join semantics
        — the supervisor touches every surviving trainer at generation
        spawn so the respawn gap can't expire them."""
        with self._lock:
            lease = self._leases.get(int(tid))
            if lease is not None and lease.alive:
                lease.last_beat = self._clock()

    def leave(self, tid: int, **info) -> bool:
        """Graceful goodbye; False if the trainer was not alive."""
        tid = int(tid)
        with self._lock:
            lease = self._leases.get(tid)
            if lease is None or not lease.alive:
                return False
            lease.alive = False
            self._version += 1
            self._set_active_gauge_locked()
        self._emit("leave", tid, **info)
        return True

    def evict(self, tid: int, cause: str = "lease-expired",
              **info) -> bool:
        """Forced removal (dead process, expired lease). Idempotent:
        evicting an already-gone trainer is a no-op returning False, so
        proc-exit detection and the lease sweep never double-count one
        death."""
        tid = int(tid)
        with self._lock:
            lease = self._leases.get(tid)
            if lease is None or not lease.alive:
                return False
            lease.alive = False
            self._version += 1
            self._set_active_gauge_locked()
        self._emit("evict", tid, cause=cause, **info)
        return True

    def sweep(self) -> List[int]:
        """Expire leases older than ``lease_s``; returns evicted tids."""
        now = self._clock()
        with self._lock:
            expired = [l.tid for l in self._leases.values()
                       if l.alive and now - l.last_beat > self.lease_s]
        return [tid for tid in expired
                if self.evict(tid, cause="lease-expired")]

    # ------------------------------------------------------------- state
    def active_trainers(self) -> List[int]:
        """Sorted tids holding a live (unexpired, unevicted) lease."""
        with self._lock:
            return sorted(l.tid for l in self._leases.values() if l.alive)

    def lease(self, tid: int) -> Optional[TrainerLease]:
        with self._lock:
            return self._leases.get(int(tid))

    @property
    def version(self) -> int:
        """Bumps on every membership change (join/rejoin/leave/evict) —
        cheap 'did anything move since I last looked' check."""
        with self._lock:
            return self._version

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "version": self._version,
                "trainers": {
                    l.tid: {"alive": l.alive, "step": l.step,
                            "beats": l.beats, "generation": l.generation}
                    for l in self._leases.values()
                },
            }


class MembershipServer:
    """The supervisor-side membership endpoint: an async-mode
    :class:`RPCServer` whose queue carries heartbeat/leave messages
    into a :class:`MembershipView`. ``poll()`` drains and sweeps."""

    def __init__(self, lease_s: float = 10.0,
                 on_event: Optional[Callable] = None, port: int = 0):
        from .rpc import RPCServer

        self.view = MembershipView(lease_s, on_event=on_event)
        # async mode: sends go straight to the pop queue — heartbeats
        # never interact with any data-plane barrier cycle. The trainer
        # count only feeds sync-mode barriers, so 1 is fine here.
        self._server = RPCServer(port=port, num_trainers=1, sync=False)
        self._server.start()
        self.endpoint = "127.0.0.1:%d" % self._server.port

    def poll(self, budget_s: float = 0.05) -> int:
        """Wait up to ``budget_s`` for membership traffic, drain what
        arrived, then sweep expired leases. Returns messages drained.
        The FIRST pop blocks for the whole budget (this is what paces a
        supervisor's monitor loop — without it the loop busy-spins);
        follow-up pops only drain what is already queued."""
        deadline = time.monotonic() + max(budget_s, 0.0)
        n = 0
        first_ms = max(int(budget_s * 1000), 1)
        while True:
            item = self._server.pop_async(
                timeout_ms=first_ms if n == 0 else 1)
            if item is None:
                break
            name, arr, _hello_tid = item
            vals = np.asarray(arr).ravel()
            if name == HB_VAR and vals.size >= 3:
                self.view.heartbeat(int(vals[0]), generation=int(vals[1]),
                                    step=int(vals[2]))
            elif name == LEAVE_VAR and vals.size >= 1:
                self.view.leave(int(vals[0]))
            n += 1
            if time.monotonic() >= deadline:
                break
        self.view.sweep()
        return n

    def active_trainers(self) -> List[int]:
        """Live trainer ids under LEASE semantics — this is the elastic
        tier's reading of the transport's ``active_trainers`` count
        (which only tracks connections and Complete messages)."""
        return self.view.active_trainers()

    def close(self) -> None:
        self._server.close()


class HeartbeatSender:
    """Trainer-side heartbeat producer. ``beat()`` stamps the
    ``trainer.heartbeat`` fault site, then pushes one HB message;
    transport errors are swallowed after the first logged warning (a
    dead membership endpoint means the supervisor is gone — the data
    plane, not the heartbeat, decides this trainer's fate), while an
    injected fault PROPAGATES (the chaos plan is aiming at us)."""

    def __init__(self, endpoint: str, tid: int, generation: int = 0):
        self.endpoint = endpoint
        self.tid = int(tid)
        self.generation = int(generation)
        self._client = None
        self._warned = False

    def _send(self, name: str, payload) -> None:
        from .rpc import RPCClient, RPCError

        try:
            if self._client is None:
                self._client = RPCClient(self.endpoint,
                                         trainer_id=self.tid)
                self._client.connect()
            self._client.send_var(name, np.asarray(payload,
                                                   dtype=np.int64))
        except (RPCError, OSError) as exc:
            if not self._warned:
                self._warned = True
                import logging

                logging.getLogger(__name__).warning(
                    "membership endpoint %s unreachable (%s); further "
                    "heartbeats from trainer %d will be dropped "
                    "silently", self.endpoint, exc, self.tid)

    def beat(self, step: int = -1) -> None:
        fault_point("trainer.heartbeat")
        self._send(HB_VAR, [self.tid, self.generation, int(step)])

    def leave(self) -> None:
        self._send(LEAVE_VAR, [self.tid, self.generation, -1])

    def close(self) -> None:
        c, self._client = self._client, None
        if c is not None:
            c.close()


# --------------------------------------------------------- reshard math
def shard_assignment(num_shards: int,
                     tids: List[int]) -> Dict[int, List[int]]:
    """Deal ``num_shards`` data shards round-robin over the SORTED
    trainer ids — THE pure function both the live job and a fresh job
    started from the same checkpoint must agree on. Every shard is
    assigned (trainers may hold zero shards when outnumbered)."""
    tids = sorted(int(t) for t in tids)
    if not tids:
        raise ValueError("cannot assign %d shards to an empty world"
                         % num_shards)
    out: Dict[int, List[int]] = {t: [] for t in tids}
    for s in range(int(num_shards)):
        out[tids[s % len(tids)]].append(s)
    return out


def make_world(num_shards: int, tids: List[int],
               cursors: Optional[Dict[int, int]] = None,
               epoch: int = 0) -> dict:
    """A fresh manifest ``world`` section: trainer count, data-shard
    assignment, and per-shard reader cursor (next batch index within
    ``epoch``)."""
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1, got %d" % num_shards)
    tids = sorted(int(t) for t in tids)
    assign = shard_assignment(num_shards, tids)
    cur = {s: 0 for s in range(num_shards)}
    if cursors:
        for s, b in cursors.items():
            cur[int(s)] = int(b)
    return {
        "version": WORLD_VERSION,
        "num_trainers": len(tids),
        "num_shards": num_shards,
        "trainers": tids,
        "assignment": {str(t): shards for t, shards in assign.items()},
        "cursors": {str(s): b for s, b in cur.items()},
        "epoch": int(epoch),
    }


def reshard(world: dict, new_tids: List[int]) -> dict:
    """Deterministic reshard: the same shards, re-dealt to ``new_tids``
    by :func:`shard_assignment`; cursors and epoch carry over. Pure —
    ``reshard(w, t)`` is the only world a resumed generation may run,
    and equals what a FRESH job launched on ``new_tids`` from the same
    manifest computes."""
    return make_world(world["num_shards"], new_tids,
                      cursors={int(s): int(b)
                               for s, b in world.get("cursors",
                                                     {}).items()},
                      epoch=int(world.get("epoch", 0)))


def _valid_world(w) -> bool:
    if not isinstance(w, dict):
        return False
    try:
        num_shards = int(w["num_shards"])
        tids = [int(t) for t in w["trainers"]]
        assign = {int(t): [int(s) for s in shards]
                  for t, shards in w["assignment"].items()}
        # everything reshard() will coerce must coerce HERE, so a bad
        # section degrades (counted) instead of crashing the caller
        int(w.get("epoch", 0))
        cursors = w.get("cursors", {})
        if not isinstance(cursors, dict):
            return False
        for s, b in cursors.items():
            int(s), int(b)
    except (KeyError, TypeError, ValueError, AttributeError):
        return False
    if num_shards < 1 or not tids:
        return False
    covered = sorted(s for shards in assign.values() for s in shards)
    return covered == list(range(num_shards))


def world_from_manifest(man: Optional[dict]
                        ) -> Tuple[Optional[dict], Optional[str]]:
    """``(world, fallback)`` from a checkpoint manifest dict.

    * manifest with a valid ``world`` section → ``(world, None)``
    * pre-elastic manifest (no ``world`` key) → a synthesized
      SINGLE-TRAINER world (one shard, cursor at the manifest's
      ``batch_in_epoch``) and ``fallback="missing"`` — an old
      checkpoint resumes as a 1-trainer job instead of crashing
    * malformed ``world`` section → ``(None, "malformed")`` — the
      caller degrades to a fresh-start world; counted in
      ``paddle_elastic_manifest_world_fallbacks_total``, never raised
    * ``man is None`` (no checkpoint at all) → ``(None, None)``
    """
    if man is None:
        return None, None
    w = man.get("world")
    if w is None:
        ELASTIC_WORLD_FALLBACKS.labels(kind="missing").inc()
        return make_world(
            1, [0],
            cursors={0: int(man.get("batch_in_epoch", 0) or 0)},
            epoch=int(man.get("epoch", 0) or 0)), "missing"
    if not _valid_world(w):
        ELASTIC_WORLD_FALLBACKS.labels(kind="malformed").inc()
        import logging

        logging.getLogger(__name__).warning(
            "manifest world section is malformed (%r); degrading to a "
            "fresh-start world", type(w).__name__)
        return None, "malformed"
    return w, None
