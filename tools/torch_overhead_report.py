#!/usr/bin/env python
"""What an op of a replayed training step costs on the card, in the port.

The cost model charges every op of a Program one ``op_overhead`` beyond
its FLOPs and bytes, probed by ``analysis/cost.py``'s
``overhead_probe_programs``. This report shows what that overhead is
made of: for the device model's probes, a chain of tiny fc layers (one
kernel an op) and each of the eleven zoo train programs of
tools/torch_cost_report.py at batch 8, it times replayed
``Executor.run`` steps (median and best, fetch included) and profiles
one replay with torch.profiler (kernels, device busy ms), then prints
the microseconds an op beyond the one-op plan's call and the kernels an
op.

    python3 tools/torch_overhead_report.py                 # on the card
    python3 tools/torch_overhead_report.py --model bert    # a subset
    python3 tools/torch_overhead_report.py --json out.json

It needs a CUDA card (a CPU step is not replayed). Exit code: 0 ok, 2
bad usage or no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 8
RUNS = 15


def _zoo_feed(main, batch):
    """Zeros of each data var's shape, the batch dim at ``batch`` (the
    zoo gate's feeds)."""
    import numpy as np

    feed = {}
    for v in main.global_block().vars.values():
        if not v.is_data:
            continue
        shape = [batch if (d is None or d < 0) else int(d)
                 for d in (v.shape or [])]
        feed[v.name] = np.zeros(shape, dtype="int64" if "int" in str(
            v.dtype or "float32") else "float32")
    return feed


def _fc_chain(depth=16, width=8):
    """A training step of ``depth`` tiny fc layers (relu, a mean loss,
    Adam): ops of one kernel each."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        h = layers.data("x", [width], dtype="float32")
        for _ in range(depth):
            h = layers.fc(h, width, act="relu")
        loss = layers.mean(layers.fc(h, 1))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, {"x": np.ones((BATCH, width), "float32")}


def _busy(events):
    """Device busy microseconds: the union of the kernels' intervals."""
    busy, end = 0.0, None
    for s0, s1 in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if end is None or s0 >= end:
            busy, end = busy + s1 - s0, s1
        elif s1 > end:
            busy, end = busy + s1 - end, s1
    return busy


def measure(main, startup, fetch, feed):
    """Replayed step ms (median and best of ``RUNS`` after an eager run,
    the capture and a first replay) and one profiled replay's kernels
    and device busy ms."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)

    def step():
        exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)

    for _ in range(3):
        step()
    ms = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        step()
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    exe.close()
    ops = main.global_block().ops
    return dict(median_ms=float(np.median(ms)), best_ms=float(min(ms)),
                kernels=len(events), busy_ms=_busy(events) / 1e3,
                ops=len(ops), adam=sum(op.type == "adam" for op in ops))


def main(argv=None):
    import torch_cost_report

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", nargs="*", default=None,
                    choices=sorted(torch_cost_report.EXAMPLE_BUILDERS),
                    help="zoo programs to report (default all)")
    ap.add_argument("--json", default=None,
                    help="also write the rows to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_overhead_report: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.analysis.cost import overhead_probe_programs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    print(card[0] if card else torch.cuda.get_device_name(0))
    probes = overhead_probe_programs()
    rows = {"call probe": measure(*probes["call"]),
            "op probe": measure(*probes["op"]),
            "fc chain": measure(*_fc_chain())}
    for name in args.model or sorted(torch_cost_report.EXAMPLE_BUILDERS):
        main_p, startup, loss = torch_cost_report.build_example(name)
        rows[name] = measure(main_p, startup, loss, _zoo_feed(main_p, BATCH))
    call = rows["call probe"]
    print("%-20s %5s %5s %9s %9s %8s %8s %9s" % (
        "program", "ops", "adam", "median ms", "best ms", "kernels",
        "k / op", "us / op"))
    for name, r in rows.items():
        r["kernels_per_op"] = r["kernels"] / r["ops"]
        r["us_per_op"] = (r["median_ms"] - call["median_ms"]) / r["ops"] * 1e3
        print("%-20s %5d %5d %9.3f %9.3f %8d %8.2f %9.3f" % (
            name, r["ops"], r["adam"], r["median_ms"], r["best_ms"],
            r["kernels"], r["kernels_per_op"], r["us_per_op"]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
