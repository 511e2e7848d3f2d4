#!/usr/bin/env python3
"""Where an elastic worker's start goes on the card.

    python3 tools/torch_worker_start.py [--procs 1,4] [--steps 12] [--cpu]

Two readings, printed as one JSON line:

1. ``imports``: for each count in ``--procs``, that many fresh Python
   processes started at once, each timing ``import torch``, ``import
   paddle_tpu_torch`` and its first CUDA operation (skipped with
   ``--cpu``); each process's seconds and the wall time of the batch.
2. ``trainer``: the elastic demo model's trainer (the program
   ``resilience.elastic.demo_builder`` builds, transpiled for one trainer
   and one pserver) trained by ``resilient_train_loop`` for ``--steps``
   steps against a pserver served from a thread of this process: the
   seconds to the first resolved step (its startup included), each later
   resolution's and their mean a step.

A worker of ``ElasticJobSupervisor`` pays both: its interpreter's
imports, then its first step.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORTS = (
    "import json, sys, time\n"
    "t0 = time.perf_counter()\n"
    "import torch\n"
    "t1 = time.perf_counter()\n"
    "import paddle_tpu_torch\n"
    "t2 = time.perf_counter()\n"
    "if sys.argv[1] == 'cuda':\n"
    "    torch.zeros(1, device='cuda')\n"
    "    torch.cuda.synchronize()\n"
    "t3 = time.perf_counter()\n"
    "print(json.dumps(dict(torch_s=t1 - t0, port_s=t2 - t1,\n"
    "                      cuda_s=t3 - t2)))\n")


def imports(n, device):
    """``n`` processes at once: each one's seconds, and the batch's wall."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _IMPORTS, device],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    each = [json.loads(p.communicate()[0].strip().splitlines()[-1])
            for p in procs]
    return dict(procs=n, each=each, wall_s=time.perf_counter() - t0)


def trainer(steps, card):
    """The demo trainer's seconds to its first step and each step after,
    against a pserver served from a thread."""
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.resilience import resilient_train_loop
    from paddle_tpu_torch.resilience.elastic import demo_builder

    place = fluid.CUDAPlace(0) if card else fluid.CPUPlace()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    ep = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()

    def transpiled():
        main, startup, fetch, feed_fn = demo_builder()
        t = fluid.DistributeTranspiler()
        t.transpile(trainer_id=0, program=main, pservers=ep, trainers=1,
                    sync_mode=True, startup_program=startup)
        return t, fetch, feed_fn

    def serve():
        t, _, _ = transpiled()
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(t.get_startup_program(ep), scope=scope)
        exe.run(t.get_pserver_program(ep), scope=scope)

    threading.Thread(target=serve, daemon=True).start()
    t, fetch, feed_fn = transpiled()
    stamps = [time.perf_counter()]
    resilient_train_loop(
        t.get_trainer_program(),
        lambda: (feed_fn(b, [0], 1) for b in range(steps)), fetch,
        scope=fluid.Scope(), checkpoint_dir=tempfile.mkdtemp(),
        startup_program=t.get_trainer_startup_program(), place=place,
        checkpoint_every=2, max_restarts=0, max_in_flight=1,
        steps_per_call=1,
        on_step=lambda s, v: stamps.append(time.perf_counter()))
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    return dict(first_step_s=gaps[0], step_s=gaps[1:],
                mean_step_s=(stamps[-1] - stamps[1]) / max(steps - 1, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", default="1,4",
                    help="comma list of process counts started at once")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="time on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    out = dict(imports=[imports(int(n), device)
                        for n in args.procs.split(",")],
               trainer=trainer(args.steps, not args.cpu))
    if not args.cpu:
        import torch

        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
