"""Multi-process launcher (reference python/paddle/distributed/launch.py
:40-80 analog).

The port's copy of paddle_tpu/distributed/launch.py, with the port's
module paths. Elastic workers run on the card unless the job asks for
the CPU (``ElasticJobSupervisor(platform="cpu")``).

Spawns one training process per local device/worker with the cluster env
contract consumed by ParallelEnv / DistributeTranspiler:
PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
PADDLE_CURRENT_ENDPOINT, PADDLE_TRAINING_ROLE, PADDLE_PSERVER_ENDPOINTS.

Usage:
    python -m paddle_tpu_torch.distributed.launch --nproc 2 train.py --args...
    python -m paddle_tpu_torch.distributed.launch --pservers 127.0.0.1:6170 \
        --trainers 2 --role all train.py        # PS cluster on localhost
    python -m paddle_tpu_torch.distributed.launch --elastic --trainers 3 \
        --elastic_steps 20 --elastic_workdir /tmp/job   # elastic PS job

``--elastic`` hands the whole job to
:class:`paddle_tpu_torch.resilience.elastic.ElasticJobSupervisor` instead of
spawning ``script`` directly: trainers join/leave mid-run under
membership leases, and every membership change reshards
deterministically from the latest checkpoint manifest (docs/
RESILIENCE.md "Elastic jobs"). The worker program comes from
``--elastic_builder module:fn`` (default: the built-in demo model).
Under ``PADDLE_TPU_VALIDATE=1`` every worker statically verifies its
generation's transpiled world before serving or training
(``analysis.validate_distributed``, counted at ``site=elastic``), so a
miscompiled reshard aborts the generation instead of deadlocking it.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys

__all__ = ["launch"]


def _parse_args(argv):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nproc", type=int, default=1,
                   help="collective mode: number of trainer processes")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--pservers", default="",
                   help="PS mode: comma list of pserver endpoints")
    p.add_argument("--trainers", type=int, default=1,
                   help="PS mode: number of trainer processes")
    p.add_argument("--role", default="trainer",
                   choices=["trainer", "pserver", "all"],
                   help="PS mode: which role(s) this host launches")
    p.add_argument("--sync_mode", type=int, default=1)
    p.add_argument("--elastic", action="store_true",
                   help="elastic PS mode: membership-supervised "
                        "trainers with deterministic reshard "
                        "(resilience.elastic)")
    p.add_argument("--elastic_steps", type=int, default=20,
                   help="elastic mode: global batches per epoch")
    p.add_argument("--elastic_workdir", default=None,
                   help="elastic mode: job state dir (checkpoints, "
                        "timeline, telemetry); default a temp dir")
    p.add_argument("--elastic_builder", default=None,
                   help="elastic mode: module:fn worker program "
                        "builder (default: the built-in demo model)")
    p.add_argument("script", nargs="?", default=None)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.elastic and args.script is None:
        p.error("script is required (unless --elastic)")
    if args.elastic and args.script is not None:
        # refusing beats silently training the demo model instead of
        # the user's script
        p.error("--elastic takes no script: elastic workers build "
                "their program from --elastic_builder module:fn")
    return args


def _spawn(script, script_args, env):
    cmd = [sys.executable, script] + list(script_args)
    full = dict(os.environ)
    full.update(env)
    return subprocess.Popen(cmd, env=full)


def launch(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    procs = []

    if args.elastic:
        import tempfile

        from ..resilience.elastic import ElasticJobSupervisor

        workdir = args.elastic_workdir or tempfile.mkdtemp(
            prefix="paddle_elastic_")
        sup = ElasticJobSupervisor(
            workdir, trainers=args.trainers,
            steps_per_epoch=args.elastic_steps,
            builder=args.elastic_builder)
        res = sup.run()
        print("elastic job: %r (workdir %s)" % (res, workdir))
        sys.exit(0 if res.completed else 1)

    if args.pservers:
        trainer_eps = ",".join(
            "%s:%d" % (args.host, args.started_port + 1000 + i)
            for i in range(args.trainers))
        common = {
            "PADDLE_PSERVER_ENDPOINTS": args.pservers,
            "PADDLE_PSERVERS": args.pservers,
            "PADDLE_TRAINERS_NUM": str(args.trainers),
            "PADDLE_TRAINER_ENDPOINTS": trainer_eps,
            "PADDLE_SYNC_MODE": str(args.sync_mode),
        }
        if args.role in ("pserver", "all"):
            for ep in args.pservers.split(","):
                env = dict(common)
                env.update({"PADDLE_TRAINING_ROLE": "PSERVER",
                            "PADDLE_CURRENT_ENDPOINT": ep})
                procs.append(_spawn(args.script, args.script_args, env))
        if args.role in ("trainer", "all"):
            for i in range(args.trainers):
                env = dict(common)
                env.update({"PADDLE_TRAINING_ROLE": "TRAINER",
                            "PADDLE_TRAINER_ID": str(i)})
                procs.append(_spawn(args.script, args.script_args, env))
    else:
        eps = ",".join("%s:%d" % (args.host, args.started_port + i)
                       for i in range(args.nproc))
        for i in range(args.nproc):
            env = {
                "PADDLE_TRAINING_ROLE": "TRAINER",
                "PADDLE_TRAINER_ID": str(i),
                "PADDLE_TRAINERS_NUM": str(args.nproc),
                "PADDLE_TRAINER_ENDPOINTS": eps,
                "PADDLE_CURRENT_ENDPOINT": eps.split(",")[i],
            }
            procs.append(_spawn(args.script, args.script_args, env))

    def _terminate(signum, frame):
        for p in procs:
            p.terminate()
        sys.exit(1)

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    rc = 0
    for p in procs:
        rc = p.wait() or rc
    sys.exit(rc)


if __name__ == "__main__":
    launch()
