"""Elastic multi-host training: membership, deterministic reshard,
chaos-proof convergence.

The port of paddle_tpu/resilience/elastic.py. Where the JAX package
hands its workers ``JAX_PLATFORMS``, the port's workers run on the card
unless the job asks for the CPU (``platform="cpu"``, handed to each
worker as ``PADDLE_TPU_ELASTIC_PLATFORM``): a trainer then passes
``CPUPlace()`` to its executor and to ``resilient_train_loop``, a
pserver serves from an ``Executor(CPUPlace())``. A worker told to use
the card on a machine without one raises before it binds a port. On the
card a pserver's dense ``sgd`` ops run, fused at level 2, as one K7
launch a sync round. Each worker's telemetry sidecar carries its kernel
launches (``paddle_elastic_worker_kernel_launches``), so the supervisor's
caller can read them.

The PS stack (distributed/),
checkpoint-resume (resilience/supervisor.py) and the fault plane
(resilience/faults.py) composed into jobs where trainers JOIN and LEAVE
mid-run. The shape is the one production elastic trainers (TorchElastic,
TF's elastic strategies) converged on — **generation-based**:

1. An :class:`ElasticJobSupervisor` owns a membership endpoint
   (:class:`~paddle_tpu_torch.distributed.membership.MembershipServer`, an
   async-mode RPC server) plus the job's worker subprocesses: one
   pserver set and one trainer per live trainer id. Every trainer runs
   :func:`~paddle_tpu_torch.resilience.supervisor.resilient_train_loop`
   over ITS data shards and heartbeats once per resolved step.
2. On a **membership change** — a worker process dies, a lease expires,
   a new trainer is admitted — the supervisor declares the current
   generation dead: surviving workers are torn down, the checkpoint
   state is archived (``reshard_g<N>/``), and a new generation is
   spawned whose world is the **pure function**
   ``reshard(manifest.world, surviving_tids)``
   (distributed/membership.py) of the latest finalized manifest.
3. The new generation resumes exactly the way a FRESH job launched on
   the surviving world from that checkpoint would: every rank restores
   scope + RNG chain from rank 0's manifest, rank 0 re-pushes the
   restored params to the fresh pservers
   (``DistributeTranspiler.get_trainer_push_program``), the others pull
   (``get_trainer_recovery_program``), readers fast-forward to the
   recorded cursor — so the two runs are **bitwise identical** by
   construction (the chaos test asserts final dense params + RNG chain
   byte-for-byte). The PS aggregates grads in trainer-id order
   (distributed/ps.py) precisely so this holds.

**Determinism contract.** A job is a fixed sequence of global batches
per epoch, split into ``num_shards`` row-slices (shard ``s`` owns rows
``s::S``). The manifest's ``world`` section records trainer count,
shard assignment and per-shard reader cursors; everything a resumed or
resharded world computes is a pure function of (manifest, new world).
Dense params and the RNG chain are bitwise; PS-held sparse tables ride
the shard-snapshot recovery path (``PADDLE_TPU_PS_RECOVER_DIR``) at
snapshot granularity — see docs/RESILIENCE.md "Elastic jobs".

**Chaos knobs.** Kill trainer k at step s by arming
``trainer.heartbeat@<s+1>:crash`` in that worker's env (the sender
beats once at join, then once per resolved step);
``tools/torch_elastic_demo.py --kill k@s`` wires exactly that. Partitioned
joins ride ``membership.join``; RPC partitions ride the existing
``rpc.send`` site. Everything lands in the ``paddle_elastic_*``
families and the ``elastic.*`` trace sites.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..observe import trace as _tr
from ..observe.families import (ELASTIC_GENERATION, ELASTIC_RESHARDS,
                                ELASTIC_RESHARD_SECONDS, REGISTRY)

__all__ = ["ElasticJobSupervisor", "ElasticJobResult", "demo_builder",
           "demo_feed", "DEMO_FEATURES", "worker_main"]

# ------------------------------------------------------- env contract
# (consumed by worker_main in the spawned subprocesses)
ENV_ROLE = "PADDLE_TPU_ELASTIC_ROLE"
ENV_TID = "PADDLE_TPU_ELASTIC_TID"
ENV_WORLD = "PADDLE_TPU_ELASTIC_WORLD"
ENV_GENERATION = "PADDLE_TPU_ELASTIC_GENERATION"
ENV_CKPT = "PADDLE_TPU_ELASTIC_CKPT"
ENV_MEMBER_EP = "PADDLE_TPU_ELASTIC_MEMBER_ENDPOINT"
ENV_STEPS = "PADDLE_TPU_ELASTIC_STEPS"
ENV_CKPT_EVERY = "PADDLE_TPU_ELASTIC_CHECKPOINT_EVERY"
ENV_BUILDER = "PADDLE_TPU_ELASTIC_BUILDER"
ENV_TELEMETRY = "PADDLE_TPU_ELASTIC_TELEMETRY_OUT"
ENV_METRICS_LINGER = "PADDLE_TPU_METRICS_LINGER_S"
ENV_PLATFORM = "PADDLE_TPU_ELASTIC_PLATFORM"
PLATFORMS = ("cuda", "cpu")

WORKER_KERNEL_LAUNCHES = REGISTRY.gauge(
    "paddle_elastic_worker_kernel_launches",
    "This worker's launches of the port's kernels at its exit: the card's "
    "own count per library and slot (kernels.build.device_launches), and "
    "each tier wrapper's launch calls from the host (slot 'host')",
    labels=("library", "slot"))
# the g_launches slots of each kernel library (csrc/*.cu)
_LAUNCH_SLOTS = {"flash_attention_fwd": 2, "flash_attention_bwd": 4,
                 "layernorm_residual": 2, "optimizer_update": 2}

# worker exit codes the supervisor reads
RC_OK = 0
RC_FAULT = 3       # transient/training fault (InjectedFault, XLA error)
RC_PEER_GONE = 7   # the data plane vanished (PeerGoneError)


# ------------------------------------------------------ demo workload
DEMO_FEATURES = 6
DEMO_BATCH = 24  # rows per GLOBAL batch (sliced into shards)


def demo_feed(step: int, shards: List[int], num_shards: int):
    """The demo job's deterministic global batch for ``step`` (0-based
    within the epoch), sliced to this worker's shards: shard ``s`` owns
    rows ``s::num_shards`` — THE pure data-sharding function both a
    live job and a resharded resume must agree on."""
    import numpy as np

    rng = np.random.RandomState(20_000 + step)
    X = rng.randn(DEMO_BATCH, DEMO_FEATURES).astype(np.float32)
    W = np.linspace(-1.0, 1.0, DEMO_FEATURES).astype(
        np.float32).reshape(-1, 1)
    Y = (X @ W + 0.25).astype(np.float32)
    rows = sorted(r for s in shards for r in range(s, DEMO_BATCH,
                                                   num_shards))
    return {"x": X[rows], "y": Y[rows]}


def demo_builder():
    """The elastic demo/chaos model: linear head over a dropout'd
    hidden layer — small enough to train in seconds, but with a REAL
    RNG chain (dropout masks) so the bitwise-resume contract covers
    more than arithmetic. Returns ``(main, startup, fetch_list,
    feed_fn)`` — the elastic worker builder contract."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[DEMO_FEATURES],
                              dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(
            x, size=8, act="relu",
            param_attr=fluid.ParamAttr(
                name="el_w1",
                initializer=fluid.initializer.Constant(0.3)),
            bias_attr=fluid.ParamAttr(
                name="el_b1",
                initializer=fluid.initializer.Constant(0.0)))
        h = fluid.layers.dropout(h, dropout_prob=0.2)
        pred = fluid.layers.fc(
            h, size=1,
            param_attr=fluid.ParamAttr(
                name="el_w2",
                initializer=fluid.initializer.Constant(0.1)),
            bias_attr=fluid.ParamAttr(
                name="el_b2",
                initializer=fluid.initializer.Constant(0.0)))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, [loss.name], demo_feed


def _resolve_builder(spec: Optional[str]):
    """'module:function' -> callable; None/'' -> the demo builder."""
    if not spec:
        return demo_builder
    modname, _, fn = spec.partition(":")
    if not fn:
        raise ValueError(
            "builder spec must be 'module:function', got %r" % spec)
    import importlib

    return getattr(importlib.import_module(modname), fn)


def _validate_world(transpiler) -> None:
    """PADDLE_TPU_VALIDATE=1: statically verify this generation's
    transpiled world (wire typing, shard coverage, barrier graph,
    translation validation — analysis/distributed.py) BEFORE any
    process of the generation starts serving or training. A reshard
    that miscompiled fails loudly here, counted at site=elastic, instead
    of deadlocking the barrier cycle mid-generation."""
    from ..analysis.infer import validation_enabled

    if not validation_enabled():
        return
    from ..analysis.distributed import validate_distributed

    validate_distributed(transpiler, site="elastic")


def _worker_place():
    """The place this worker runs on: the card unless the job asked for
    the CPU; on a machine without a card, a card worker raises here,
    before it binds a port or connects to one."""
    from ..core.place import CPUPlace, CUDAPlace, require_device

    platform = os.environ.get(ENV_PLATFORM, "cuda")
    if platform not in PLATFORMS:
        raise ValueError("%s=%r: the platforms are %s"
                         % (ENV_PLATFORM, platform, PLATFORMS))
    place = CPUPlace() if platform == "cpu" else CUDAPlace(0)
    require_device(place.torch_device())
    return place


# ------------------------------------------------------- worker mains
def _run_trainer(place) -> int:
    from ..distributed.membership import HeartbeatSender, make_world

    world = json.loads(os.environ[ENV_WORLD])
    tid = int(os.environ[ENV_TID])
    tids = [int(t) for t in world["trainers"]]
    rank = tids.index(tid)
    shards = [int(s) for s in world["assignment"][str(tid)]]
    num_shards = int(world["num_shards"])
    steps = int(os.environ[ENV_STEPS])
    ck_every = int(os.environ.get(ENV_CKPT_EVERY, "2"))
    generation = int(os.environ.get(ENV_GENERATION, "0"))
    ckpt_dir = os.environ[ENV_CKPT]
    member_ep = os.environ.get(ENV_MEMBER_EP, "")
    pservers = os.environ["PADDLE_PSERVER_ENDPOINTS"]

    import paddle_tpu_torch as fluid
    from ..ops.distributed_ops import complete_and_reset
    from .supervisor import read_manifest, resilient_train_loop

    builder = _resolve_builder(os.environ.get(ENV_BUILDER))
    main, startup, fetch_list, feed_fn = builder()
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=rank, program=main, pservers=pservers,
                trainers=len(tids), sync_mode=True,
                startup_program=startup)
    _validate_world(t)
    trainer_prog = t.get_trainer_program()

    hb = HeartbeatSender(member_ep, tid, generation) if member_ep \
        else None
    if hb is not None:
        hb.beat(0)  # join announce (trainer.heartbeat occurrence 1)

    man = read_manifest(ckpt_dir)
    if man is not None:
        # resumed generation: restore happens inside the train loop;
        # rank 0 then re-publishes the restored params to the fresh
        # pservers, every other rank pulls — one init-parity cycle
        startup_p = None
        resume_p = (t.get_trainer_push_program() if rank == 0
                    else t.get_trainer_recovery_program())
    else:
        startup_p = t.get_trainer_startup_program()
        resume_p = None

    def reader():
        def batches():
            for b in range(steps):
                yield feed_fn(b, shards, num_shards)
        return batches()

    def manifest_world(step, epoch, batch_in_epoch):
        # in the sync barrier cycle every shard advances in lockstep:
        # at a checkpoint, every shard's cursor IS batch_in_epoch
        return {"world": make_world(
            num_shards, tids,
            cursors={s: batch_in_epoch for s in range(num_shards)},
            epoch=epoch)}

    res = resilient_train_loop(
        trainer_prog, reader, fetch_list,
        checkpoint_dir=ckpt_dir,
        place=place,
        startup_program=startup_p,
        resume_program=resume_p,
        # rank 0 owns THE manifest; everyone else is read-only against
        # the shared checkpoint dir
        checkpoint_every=(ck_every if rank == 0 else 0),
        manifest_extra=manifest_world,
        epochs=1,
        max_restarts=0,  # fail fast: recovery is the SUPERVISOR's job
        on_step=(lambda s, _v: hb.beat(s)) if hb is not None
        else None,
        # window 1: the compiled step carries ordered RPC callbacks —
        # overlapping two in-flight steps would interleave two barrier
        # cycles on the wire. steps_per_call pinned for the same
        # reason, and because heartbeats ride on_step: left to
        # auto-resolve, a global PADDLE_TPU_STEPS_PER_CALL=50 would
        # beat once per 50-step window and expire the live trainer's
        # membership lease mid-window
        max_in_flight=1,
        steps_per_call=1,
    )
    complete_and_reset()  # Complete -> the pserver loop can drain
    if hb is not None:
        hb.close()
    print("trainer %d done: steps=%d resumed_from=%r"
          % (tid, res.steps, res.resumed_from), flush=True)
    return RC_OK


def _run_pserver(place) -> int:
    import paddle_tpu_torch as fluid

    world = json.loads(os.environ[ENV_WORLD])
    tids = [int(t) for t in world["trainers"]]
    endpoint = os.environ["PADDLE_CURRENT_ENDPOINT"]
    pservers = os.environ["PADDLE_PSERVER_ENDPOINTS"]
    builder = _resolve_builder(os.environ.get(ENV_BUILDER))
    main, startup, _fetch, _feed = builder()
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=pservers,
                trainers=len(tids), sync_mode=True,
                startup_program=startup)
    _validate_world(t)
    exe = fluid.Executor(place)
    exe.run(t.get_startup_program(endpoint))
    # the serving loop waits for each round's grads inside the native
    # transport, where no Python signal handler runs: it serves on a
    # thread, and this (main) thread stays where a teardown's SIGTERM is
    # handled at once (the shutdown handlers flush the sidecar), instead
    # of outliving the supervisor's grace and dying of SIGKILL
    err = []

    def serve():
        try:
            exe.run(t.get_pserver_program(endpoint))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)

    th = threading.Thread(target=serve, name="paddle-tpu-pserver",
                          daemon=True)
    th.start()
    while th.is_alive():
        th.join(0.1)
        _record_kernel_launches(device=False)
    if err:
        raise err[0]
    return RC_OK


def _record_kernel_launches(device: bool = True) -> None:
    """This worker's kernel launches into WORKER_KERNEL_LAUNCHES: the
    tier wrappers' launch calls and, with ``device``, the card's own
    counts of each kernel library this process loaded (none is built or
    loaded here)."""
    import torch

    from ..kernels import build
    from ..kernels import layernorm as ln
    from ..kernels import optimizer_update as ou

    for name, fn in (("layernorm_residual", ln.layernorm_residual_fwd),
                     ("optimizer_update.adam", ou.adam_group),
                     ("optimizer_update.sgd", ou.sgd_group)):
        WORKER_KERNEL_LAUNCHES.labels(library=name, slot="host").set(
            fn.launches)
    loaded = [n for n in _LAUNCH_SLOTS if n in build._LOADED]
    if device and loaded and torch.cuda.is_available():
        torch.cuda.synchronize()
        for name in loaded:
            for i, v in enumerate(build.device_launches(
                    name, _LAUNCH_SLOTS[name])):
                WORKER_KERNEL_LAUNCHES.labels(library=name,
                                              slot=str(i)).set(v)


def _dump_worker_telemetry() -> None:
    out = os.environ.get(ENV_TELEMETRY)
    if not out:
        return
    try:
        from .. import observe

        _record_kernel_launches()
        observe.dump(out)
    except Exception as exc:  # sidecars are best-effort forensics
        print("telemetry sidecar failed: %s" % exc, file=sys.stderr)


def _linger_and_stop_exporter() -> None:
    """Normal-exit exporter teardown: hold ``/metrics`` open for
    ``PADDLE_TPU_METRICS_LINGER_S`` extra seconds so a fleet scraper
    can catch the FINAL (post-sidecar-dump) state before the socket
    disappears, then stop the thread."""
    from ..observe.export import active_exporter, stop_exporter

    if active_exporter() is None:
        return
    try:
        linger = float(os.environ.get(ENV_METRICS_LINGER) or 0.0)
    except ValueError:
        linger = 0.0
    if linger > 0:
        time.sleep(linger)
    stop_exporter()


def worker_main(argv: Optional[List[str]] = None) -> int:
    """Entry for spawned elastic workers
    (``python -m paddle_tpu_torch.resilience.elastic``); the role and the
    whole job spec ride the PADDLE_TPU_ELASTIC_* env contract. A card
    worker with no card raises before anything binds a port."""
    del argv
    from ..observe import export as _export
    from ..observe import shutdown as _shutdown

    place = _worker_place()
    role = os.environ.get(ENV_ROLE, "trainer")
    # fleet telemetry: every worker exports live metrics when the
    # supervisor's environment asks for it (PADDLE_TPU_METRICS_PORT;
    # _spawn hands each worker its own port-file rendezvous), and a
    # supervisor SIGTERM flushes the same sidecar the normal exit
    # path writes — a torn-down worker leaves forensics, not nothing
    _export.start_from_env()
    out = os.environ.get(ENV_TELEMETRY)
    if out:
        os.environ.setdefault(_shutdown.ENV_SIDECAR, out)
    _shutdown.install_shutdown_handlers()
    try:
        if role == "pserver":
            return _run_pserver(place)
        return _run_trainer(place)
    except BaseException as exc:
        from ..distributed.rpc import PeerGoneError

        import traceback

        traceback.print_exc()
        if isinstance(exc, PeerGoneError) or \
                "PeerGoneError" in repr(exc):
            return RC_PEER_GONE
        if isinstance(exc, (KeyboardInterrupt, SystemExit)):
            raise
        return RC_FAULT
    finally:
        _dump_worker_telemetry()
        _linger_and_stop_exporter()


# --------------------------------------------------------- supervisor
class ElasticJobResult:
    """What :meth:`ElasticJobSupervisor.run` hands back."""

    __slots__ = ("completed", "generations", "evictions", "rejoins",
                 "reshards", "final_step", "timeline", "checkpoint_dir",
                 "error")

    def __init__(self):
        self.completed = False
        self.generations = 0
        self.evictions = 0
        self.rejoins = 0
        self.reshards = []       # [{"cause", "generation", ...}]
        self.final_step = None
        self.timeline = []       # every timeline event, in order
        self.checkpoint_dir = None
        self.error = None

    def __repr__(self):
        return ("ElasticJobResult(completed=%s, generations=%d, "
                "evictions=%d, rejoins=%d, final_step=%r, error=%r)"
                % (self.completed, self.generations, self.evictions,
                   self.rejoins, self.final_step, self.error))


def _free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class ElasticJobSupervisor:
    """Run one elastic training job (module doc above).

    ``workdir`` holds everything: ``checkpoints/`` (the shared manifest
    + step dirs), ``logs/`` (per-process stdout), ``timeline.jsonl``
    (the membership/reshard story, one JSON event per line),
    ``telemetry.json`` (the supervisor's metric snapshot — the sidecar
    ``tools/elastic_demo.py`` prints), ``telemetry/`` (per-worker
    snapshots) and ``reshard_g<N>/`` (the checkpoint state each reshard
    resumed from — the exact input for a reference run).

    ``worker_env`` maps trainer id -> extra env applied to that
    trainer's FIRST spawn only (chaos plans live here; a respawned or
    rejoined trainer starts clean). ``rejoin`` maps trainer id -> step:
    once any live trainer reports that step, an evicted/never-admitted
    trainer id is admitted (a membership change -> reshard)."""

    def __init__(self, workdir: str, *,
                 trainers: int = 3,
                 trainer_ids: Optional[List[int]] = None,
                 num_shards: Optional[int] = None,
                 num_pservers: int = 1,
                 steps_per_epoch: int = 10,
                 checkpoint_every: int = 2,
                 lease_s: float = 10.0,
                 poll_s: float = 0.05,
                 builder: Optional[str] = None,
                 worker_env: Optional[Dict[int, Dict[str, str]]] = None,
                 rejoin: Optional[Dict[int, int]] = None,
                 max_generations: int = 8,
                 platform: str = "cuda",
                 ps_recover_dir: Optional[str] = None):
        self.workdir = os.path.abspath(workdir)
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        self.tids = sorted(int(t) for t in (
            trainer_ids if trainer_ids is not None
            else range(trainers)))
        if not self.tids:
            raise ValueError("an elastic job needs at least one trainer")
        self.num_shards = int(num_shards if num_shards is not None
                              else len(self.tids))
        self.num_pservers = int(num_pservers)
        self.steps_per_epoch = int(steps_per_epoch)
        self.checkpoint_every = int(checkpoint_every)
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.builder = builder
        self.worker_env = {int(t): dict(e)
                           for t, e in (worker_env or {}).items()}
        self.rejoin = {int(t): int(s)
                       for t, s in (rejoin or {}).items()}
        self.max_generations = int(max_generations)
        if platform not in PLATFORMS:
            raise ValueError("platform must be one of %s, got %r"
                             % (PLATFORMS, platform))
        self.platform = platform
        self.ps_recover_dir = ps_recover_dir
        self._spawned_once: set = set()
        self._events: deque = deque()
        self._timeline_path = os.path.join(self.workdir,
                                           "timeline.jsonl")
        self.result = ElasticJobResult()
        self.result.checkpoint_dir = self.ckpt_dir

    # ------------------------------------------------------- timeline
    def _timeline(self, event: str, **info) -> None:
        rec = {"t": round(time.time(), 3), "event": event}
        rec.update(info)
        self.result.timeline.append(rec)
        with open(self._timeline_path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")

    def _on_membership_event(self, event: str, tid: int, **info) -> None:
        # runs on the monitor thread (MembershipServer.poll); queue the
        # event for the generation loop AND record it in the timeline
        self._timeline(event, trainer=tid, **info)
        self._events.append((event, tid, info))
        if event == "evict":
            self.result.evictions += 1
        elif event == "rejoin":
            self.result.rejoins += 1

    # ---------------------------------------------------------- spawn
    def _spawn(self, role: str, world: dict, generation: int,
               member_ep: str, pserver_eps: List[str],
               tid: Optional[int] = None):
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        env[ENV_PLATFORM] = self.platform
        env.update({
            ENV_ROLE: role,
            ENV_WORLD: json.dumps(world),
            ENV_GENERATION: str(generation),
            ENV_CKPT: self.ckpt_dir,
            ENV_MEMBER_EP: member_ep,
            ENV_STEPS: str(self.steps_per_epoch),
            ENV_CKPT_EVERY: str(self.checkpoint_every),
            "PADDLE_PSERVER_ENDPOINTS": ",".join(pserver_eps),
            "PADDLE_TRAINERS_NUM": str(len(world["trainers"])),
            "PADDLE_SYNC_MODE": "1",
        })
        if self.builder:
            env[ENV_BUILDER] = self.builder
        if role == "pserver":
            env["PADDLE_CURRENT_ENDPOINT"] = pserver_eps[int(tid)]
            env["PADDLE_TRAINING_ROLE"] = "PSERVER"
            if self.ps_recover_dir and generation > 0:
                env["PADDLE_TPU_PS_RECOVER_DIR"] = self.ps_recover_dir
            env[ENV_TELEMETRY] = os.path.join(
                self.workdir, "telemetry",
                "gen%d_pserver%d.json" % (generation, tid))
            log_name = "gen%d_pserver%d.log" % (generation, tid)
        else:
            rank = world["trainers"].index(tid)
            env[ENV_TID] = str(tid)
            env["PADDLE_TRAINER_ID"] = str(rank)
            env["PADDLE_TRAINING_ROLE"] = "TRAINER"
            env[ENV_TELEMETRY] = os.path.join(
                self.workdir, "telemetry",
                "gen%d_trainer%d.json" % (generation, tid))
            if tid not in self._spawned_once:
                # chaos env applies to the FIRST spawn only: a
                # respawned survivor or a rejoined trainer starts
                # clean (its fault plan already fired)
                env.update(self.worker_env.get(tid, {}))
            self._spawned_once.add(tid)
            log_name = "gen%d_trainer%d.log" % (generation, tid)
        from ..observe.export import ENV_PORT, ENV_PORT_FILE

        if env.get(ENV_PORT):
            # exporting fleet: each worker gets its own port-file
            # rendezvous, named per instance (not per generation) so a
            # scraper follows the same file across respawns
            env[ENV_PORT_FILE] = os.path.join(
                self.workdir, "telemetry", "%s%d.port" % (role, tid))
        log_path = os.path.join(self.workdir, "logs", log_name)
        log_f = open(log_path, "ab")
        # -c (not -m): runpy would import the module a second time as
        # __main__ on top of the package import, duplicating module
        # state and warning about it
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; "
             "from paddle_tpu_torch.resilience.elastic import worker_main; "
             "sys.exit(worker_main())"],
            env=env, stdout=log_f, stderr=subprocess.STDOUT)
        return proc, log_f, log_path

    @staticmethod
    def _teardown(procs, grace_s: float = 10.0) -> None:
        for proc, log_f, _p in procs:
            if proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + grace_s
        for proc, log_f, _p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            try:
                proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log_f.close()

    @staticmethod
    def _log_tail(path: str, lines: int = 15) -> str:
        try:
            with open(path, "rb") as f:
                return b"\n".join(
                    f.read().splitlines()[-lines:]).decode(
                        errors="replace")
        except OSError:
            return "<no log>"

    # ------------------------------------------------------------ run
    def _build_world(self):
        from ..distributed.membership import (make_world, reshard,
                                              world_from_manifest)
        from .supervisor import read_manifest

        man = read_manifest(self.ckpt_dir)
        world, fallback = world_from_manifest(man)
        if world is not None:
            # covers the pre-elastic "missing" fallback too: an old
            # manifest resumes as the synthesized single-trainer world
            # re-dealt to the configured trainers
            return reshard(world, self.tids), man
        # no manifest at all, or a malformed world section (counted by
        # world_from_manifest): fresh-start world
        return make_world(self.num_shards, self.tids), man

    def admit(self, tid: int) -> None:
        """Admit a trainer id into the job (a membership change: the
        current generation reshards to include it)."""
        tid = int(tid)
        if tid not in self.tids:
            self._events.append(("admit", tid, {}))

    def run(self, timeout_s: float = 600.0) -> ElasticJobResult:
        from ..distributed.membership import MembershipServer

        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(os.path.join(self.workdir, "logs"), exist_ok=True)
        os.makedirs(os.path.join(self.workdir, "telemetry"),
                    exist_ok=True)
        deadline = time.monotonic() + timeout_s
        ms = MembershipServer(self.lease_s,
                              on_event=self._on_membership_event)
        res = self.result
        try:
            generation = 0
            while True:
                if generation >= self.max_generations:
                    res.error = ("gave up after %d generations"
                                 % generation)
                    break
                if not self.tids:
                    res.error = "no trainers left in the world"
                    break
                world, man = self._build_world()
                if man is not None and man.get("completed"):
                    res.completed = True
                    res.final_step = man.get("step")
                    break
                resume_step = man["step"] if man else 0
                ELASTIC_GENERATION.set(generation)
                res.generations = generation + 1
                self._timeline(
                    "generation_start", generation=generation,
                    trainers=world["trainers"],
                    assignment=world["assignment"],
                    resume_step=resume_step)
                ports = _free_ports(self.num_pservers)
                ps_eps = ["127.0.0.1:%d" % p for p in ports]
                procs = []  # [(proc, log_f, log_path)]
                trainer_procs: Dict[int, tuple] = {}
                sp = _tr.trace_span("elastic.generation",
                                    generation=generation,
                                    trainers=len(world["trainers"])) \
                    if _tr.trace_enabled() else None
                if sp is not None:
                    sp.__enter__()
                pserver_procs = []
                try:
                    for i in range(self.num_pservers):
                        entry = self._spawn(
                            "pserver", world, generation, ms.endpoint,
                            ps_eps, tid=i)
                        procs.append(entry)
                        pserver_procs.append(entry)
                    for tid in world["trainers"]:
                        entry = self._spawn("trainer", world,
                                            generation, ms.endpoint,
                                            ps_eps, tid=tid)
                        procs.append(entry)
                        trainer_procs[tid] = entry
                        ms.view.touch(tid)
                    change = self._monitor(ms, world, trainer_procs,
                                           pserver_procs, deadline)
                except BaseException:
                    # a failed spawn or a monitor crash must not leak
                    # live worker processes (a pserver blocked in
                    # wait_grads outlives the supervisor otherwise)
                    self._teardown(procs)
                    raise
                finally:
                    if sp is not None:
                        sp.__exit__(None, None, None)
                if change is None:        # timeout
                    self._teardown(procs)
                    res.error = "job timeout after %.0fs" % timeout_s
                    break
                cause, info = change
                if cause == "completed":
                    # graceful drain: workers already exited (or will
                    # momentarily — the pserver drains on Complete)
                    self._teardown(procs, grace_s=15.0)
                    res.completed = True
                    res.final_step = info.get("step")
                    self._timeline("completed", step=res.final_step,
                                   generation=generation)
                    break
                # ---- membership change: reshard into generation g+1
                t0 = time.perf_counter()
                span = _tr.trace_span("elastic.reshard", cause=cause,
                                      generation=generation) \
                    if _tr.trace_enabled() else None
                if span is not None:
                    span.__enter__()
                try:
                    self._teardown(procs)
                    archive = os.path.join(
                        self.workdir, "reshard_g%d" % generation)
                    if os.path.isdir(self.ckpt_dir) and \
                            not os.path.exists(archive):
                        shutil.copytree(self.ckpt_dir, archive)
                finally:
                    if span is not None:
                        span.__exit__(None, None, None)
                ELASTIC_RESHARDS.labels(cause=cause).inc()
                dt = time.perf_counter() - t0
                ELASTIC_RESHARD_SECONDS.observe(dt)
                rec = {"cause": cause, "generation": generation,
                       "resume_step": resume_step,
                       "trainers": sorted(self.tids),
                       "seconds": round(dt, 3)}
                rec.update(info)
                res.reshards.append(rec)
                self._timeline("reshard", **rec)
                generation += 1
        finally:
            ms.close()
            try:
                from .. import observe

                observe.dump(os.path.join(self.workdir,
                                          "telemetry.json"))
            except Exception as exc:
                print("supervisor telemetry dump failed: %s" % exc,
                      file=sys.stderr)
        return res

    def _monitor(self, ms, world, trainer_procs, pserver_procs,
                 deadline):
        """Watch one generation. Returns ``(cause, info)`` — a
        membership change ('evict'/'leave'/'join'), or 'completed' —
        or None on timeout. Mutates ``self.tids`` to the next world."""
        from .supervisor import read_manifest

        world_tids = list(world["trainers"])
        handled: set = set()       # tids whose exit was processed
        clean_exit_at: Dict[int, float] = {}  # rc=0 before job done
        leave_grace_s = 10.0
        while True:
            if time.monotonic() > deadline:
                return None
            ms.poll(self.poll_s)
            man = read_manifest(self.ckpt_dir)
            job_done = bool(man and man.get("completed"))
            # 1) supervisor-driven admissions + membership events
            while self._events:
                event, tid, info = self._events.popleft()
                if event == "admit" and tid not in self.tids:
                    self.tids = sorted(self.tids + [tid])
                    self._timeline("admit", trainer=tid)
                    return "join", {"trainer": tid}
                if event in ("evict", "leave") and tid in world_tids \
                        and tid in self.tids and not job_done:
                    self.tids = sorted(set(self.tids) - {tid})
                    return event, {"trainer": tid,
                                   "detail": info.get("cause")}
            # 2) scheduled rejoins: trigger once progress reaches the
            #    configured step
            if self.rejoin and not job_done:
                snap = ms.view.snapshot()["trainers"]
                live_steps = [v["step"] for v in snap.values()
                              if v["alive"]]
                top = max(live_steps) if live_steps else -1
                for tid, at_step in sorted(self.rejoin.items()):
                    if tid not in self.tids and top >= at_step:
                        del self.rejoin[tid]
                        self.admit(tid)
                        break
            # 3) worker process exits
            now = time.monotonic()
            for tid, (proc, _f, log_path) in trainer_procs.items():
                rc = proc.poll()
                if rc is None or tid in handled:
                    continue
                if job_done:
                    handled.add(tid)
                    continue
                if rc == 0:
                    # clean exit before the manifest says completed:
                    # usually rank 0's final write racing this poll —
                    # give it a grace window before calling it a leave
                    t0 = clean_exit_at.setdefault(tid, now)
                    if now - t0 > leave_grace_s:
                        handled.add(tid)
                        ms.view.leave(tid, cause="early clean exit")
                        break
                    continue
                # crashed: evict (idempotent vs the lease sweep)
                handled.add(tid)
                ms.view.evict(tid, cause="proc-exit rc=%d" % rc,
                              log_tail=self._log_tail(log_path, 3))
                # the evict event lands in self._events via on_event;
                # loop back so stage (1) consumes it uniformly
                break
            # 4) a dead pserver wedges every trainer: reshard the SAME
            #    trainer world onto a fresh data plane
            if not job_done:
                for entry in pserver_procs:
                    rc = entry[0].poll()
                    if rc is not None and id(entry) not in handled:
                        handled.add(id(entry))
                        return "evict", {
                            "trainer": None,
                            "detail": "pserver-exit rc=%d" % rc,
                            "log_tail": self._log_tail(entry[2], 3)}
            # 5) completion: manifest says done and every trainer of
            #    this generation exited
            if job_done:
                all_exited = all(p[0].poll() is not None
                                 for p in trainer_procs.values())
                if all_exited:
                    return "completed", {"step": man.get("step")}


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
