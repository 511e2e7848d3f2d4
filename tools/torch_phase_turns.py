"""Two checkouts of the repo in turns on one CUDA card: chip_smoke.py's
phases 8c (GPT-2 small's ``generate`` at batch 1 and 8) and 10c
(ResNet-50 served by the Predictor at batch 1 and 8), each after the
phase that trains its weights (8, 10), in the order A B B A. Each run is
a process of its own in its checkout (its kernels built from that
checkout's sources), and prints one JSON line: the replayed token and
prefill ms of each batch, and the Predictor's latency medians. Host
time moves between machines, so compare two versions within one run of
this script.

Run on a machine with one CUDA card, each checkout holding chip_smoke.py::

    python3 tools/torch_phase_turns.py A_DIR B_DIR [--out OUT]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile


def one(checkout):
    """Phases 8, 8c, 10 and 10c of ``checkout``'s chip_smoke.py."""
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    import chip_smoke as cs

    cs.phase_card()
    cs.phase_build()
    gpt = cs.phase_gpt_train(cs.SEED, False)
    gen = cs.phase_gpt_generate(cs.SEED, gpt.pop("params"))
    del gpt
    cs._free()
    resnet = cs.phase_resnet_train(cs.SEED, False)
    with tempfile.TemporaryDirectory() as workdir:
        serve = cs.phase_resnet_serve(workdir, cs.SEED, resnet.pop("state"))
    return dict(
        generate={b: dict(token_median_ms=r["token_median_ms"],
                          prefill_ms=r["prefill_ms"])
                  for b, r in gen.items()},
        resnet_serve=dict(batches=serve["batches"],
                          latency_median_ms=serve["latency_median_ms"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", help="also write the runs to OUT/turns.json")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("TURN " + json.dumps(one(os.path.abspath(args.a))))
        return 0
    env = dict(os.environ, PADDLE_TPU_KERNEL_CACHE_DIR="0")
    runs = []
    for label, checkout in (("A", args.a), ("B", args.b), ("B", args.b),
                            ("A", args.a)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), checkout, checkout,
             "--one"], env=env, capture_output=True, text=True, check=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
        runs.append(dict(label=label, checkout=checkout,
                         **json.loads(line[-1][5:])))
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "turns.json"), "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
