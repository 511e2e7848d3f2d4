#!/usr/bin/env python
"""Elastic-training demo of the PyTorch port: launch, kill, (optionally)
rejoin, narrate.

The port's copy of tools/elastic_demo.py. Launches an N-trainer local
elastic job on the built-in demo model
(paddle_tpu_torch/resilience/elastic.py), every worker on the card, or
on the CPU with ``--cpu``; kills trainer k at step s by arming
the ``trainer.heartbeat`` FaultPlan site in that worker's env (the same
grammar and machinery the chaos tests use), optionally re-admits it at
a later step, and prints the membership/reshard event timeline from the
job's telemetry sidecars.

    python tools/torch_elastic_demo.py --trainers 3 --steps 10 --kill 1@4
    python tools/torch_elastic_demo.py --trainers 3 --steps 12 --kill 1@4 \
        --rejoin 1@7 --json --cpu

Exit 0 when the job completes; 1 otherwise. See docs/RESILIENCE.md
"Elastic jobs" for what each timeline event means. Under
``PADDLE_TPU_VALIDATE=1`` each worker statically verifies its
generation's transpiled world before running it (docs/ANALYSIS.md
"Distributed verification", counted at ``site=elastic``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)


def _parse_at(spec: str, flag: str):
    """'TID@STEP' -> (tid, step)."""
    try:
        tid, step = spec.split("@", 1)
        return int(tid), int(step)
    except ValueError:
        raise SystemExit("%s wants TID@STEP (e.g. 1@4), got %r"
                         % (flag, spec))


def build_supervisor(args, workdir: str):
    """The ONE recipe shared by this CLI and the fast test: an elastic
    job with an optional kill-at-step fault plan and rejoin schedule."""
    from paddle_tpu_torch.resilience.elastic import ElasticJobSupervisor

    worker_env = {}
    if args.kill:
        tid, step = _parse_at(args.kill, "--kill")
        # heartbeat occurrences: 1 at join, then one per resolved step
        # -> occurrence step+1 fires DURING step `step`'s on_step
        worker_env[tid] = {
            "PADDLE_TPU_FAULT_PLAN":
                "trainer.heartbeat@%d:crash" % (step + 1)}
    rejoin = {}
    if args.rejoin:
        tid, step = _parse_at(args.rejoin, "--rejoin")
        rejoin[tid] = step
    return ElasticJobSupervisor(
        workdir,
        trainers=args.trainers,
        steps_per_epoch=args.steps,
        checkpoint_every=args.checkpoint_every,
        lease_s=args.lease,
        worker_env=worker_env,
        rejoin=rejoin,
        platform="cpu" if args.cpu else "cuda",
    )


def print_timeline(workdir: str, out=sys.stdout):
    """Render the job's story from its sidecars: the timeline JSONL
    plus the supervisor's metric snapshot (telemetry.json)."""
    tl_path = os.path.join(workdir, "timeline.jsonl")
    print("— timeline (%s) —" % tl_path, file=out)
    t0 = None
    try:
        with open(tl_path) as f:
            events = [json.loads(line) for line in f if line.strip()]
    except OSError:
        print("  <no timeline written>", file=out)
        return
    for ev in events:
        t0 = t0 if t0 is not None else ev["t"]
        extra = {k: v for k, v in ev.items()
                 if k not in ("t", "event", "log_tail")}
        print("  +%6.2fs  %-16s %s"
              % (ev["t"] - t0, ev["event"],
                 " ".join("%s=%s" % kv for kv in sorted(extra.items()))),
              file=out)
    side = os.path.join(workdir, "telemetry.json")
    try:
        with open(side) as f:
            snap = json.load(f)["metrics"]
    except (OSError, KeyError, ValueError):
        return
    print("— paddle_elastic_* counters (%s) —" % side, file=out)
    for fam, rec in sorted(snap.items()):
        if not fam.startswith("paddle_elastic"):
            continue
        for s in rec.get("samples", []):
            val = s.get("value", s.get("count"))
            if val:
                lbl = ",".join("%s=%s" % kv
                               for kv in sorted(s.get("labels",
                                                      {}).items()))
                print("  %s{%s} %s" % (fam, lbl, val), file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="elastic multi-trainer chaos demo")
    ap.add_argument("--trainers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10,
                    help="global batches in the (single) epoch")
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--kill", default=None, metavar="TID@STEP",
                    help="SIGKILL trainer TID at step STEP via the "
                         "trainer.heartbeat fault site")
    ap.add_argument("--rejoin", default=None, metavar="TID@STEP",
                    help="re-admit trainer TID once any live trainer "
                         "reports STEP")
    ap.add_argument("--lease", type=float, default=15.0,
                    help="membership lease seconds")
    ap.add_argument("--workdir", default=None,
                    help="job state dir (default: a temp dir, kept)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON object instead "
                         "of the human timeline")
    ap.add_argument("--cpu", action="store_true",
                    help="run every worker on the CPU (default: the card)")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="elastic_demo_")
    sup = build_supervisor(args, workdir)
    res = sup.run(timeout_s=args.timeout)
    if args.json:
        print(json.dumps({
            "completed": res.completed,
            "generations": res.generations,
            "evictions": res.evictions,
            "rejoins": res.rejoins,
            "reshards": res.reshards,
            "final_step": res.final_step,
            "error": res.error,
            "workdir": workdir,
        }, sort_keys=True))
    else:
        print_timeline(workdir)
        print("result: %r" % res)
        print("workdir: %s" % workdir)
    return 0 if res.completed else 1


if __name__ == "__main__":
    sys.exit(main())
