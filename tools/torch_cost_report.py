#!/usr/bin/env python
"""Roofline cost report over the model zoo's train programs, in the port.

The port's counterpart of tools/cost_report.py (same flags): build one
or more of the eleven example train programs of tools/lint_program.py
with ``paddle_tpu_torch`` (``EXAMPLE_BUILDERS``, the same models at the
same sizes, so each builds the JAX package's Program), price every op
with ``paddle_tpu_torch.analysis.cost`` and report per-op-type FLOPs,
bytes moved, roofline seconds, the predicted step time and the
predicted MFU on the resolved device model: on an H100 its datasheet
peaks by dtype and probed overheads, on the CPU a calibration.

    python tools/torch_cost_report.py                      # all examples
    python tools/torch_cost_report.py --model gpt resnet   # a subset
    python tools/torch_cost_report.py --batch-size 64      # evaluate B
    python tools/torch_cost_report.py --steps-per-call 10  # window mode
    python tools/torch_cost_report.py --top 20             # more op rows
    python tools/torch_cost_report.py --json               # machine-readable

The prediction is an analytic bracket: it cannot see kernel fusion or
overlap. ``chip_smoke.py`` phase 18 holds it within
``ZOO_COST_GATE_FACTOR`` of the measured replayed step on the card.
The device model comes from ``DeviceModel.current()`` (env overrides >
persisted calibration > the card's peak table and probed overheads >
probe).

Exit code: 0 ok, 2 bad usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXAMPLE_BUILDERS = {}


def _example(name):
    def deco(fn):
        EXAMPLE_BUILDERS[name] = fn
        return fn

    return deco


@_example("mnist")
def _build_mnist():
    from paddle_tpu_torch.models import mnist

    return mnist.build("cnn")[0]


@_example("gpt")
def _build_gpt():
    from paddle_tpu_torch.models import gpt

    cfg = dict(d_model=32, d_ff=64, n_head=2, n_layer=1, vocab=64,
               max_length=32, dropout=0.0)
    return gpt.build(cfg, seq_len=16)[0]


@_example("resnet")
def _build_resnet():
    from paddle_tpu_torch.models import resnet

    return resnet.build(class_dim=10, image_shape=(3, 32, 32))[0]


@_example("transformer")
def _build_transformer():
    from paddle_tpu_torch.models import transformer

    cfg = dict(d_model=32, d_ff=64, n_head=4, n_layer=2, src_vocab=100,
               trg_vocab=100, max_length=16, dropout=0.1)
    return transformer.build(cfg, seq_len=16)[0]


@_example("bert")
def _build_bert():
    from paddle_tpu_torch.models import bert

    cfg = dict(d_model=32, d_ff=64, n_head=4, n_layer=2, vocab=100,
               type_vocab=2, max_length=64, dropout=0.1)
    return bert.build(cfg, seq_len=16, max_mask=4)[0]


@_example("ctr")
def _build_ctr():
    from paddle_tpu_torch.models import ctr

    return ctr.build("deepfm", vocab=1000, emb_dim=8)[0]


@_example("vgg")
def _build_vgg():
    from paddle_tpu_torch.models import vgg

    return vgg.build(class_dim=10, image_shape=(3, 32, 32))[0]


@_example("se_resnext")
def _build_se_resnext():
    from paddle_tpu_torch.models import se_resnext

    return se_resnext.build(class_dim=10, image_shape=(3, 32, 32))[0]


@_example("vit")
def _build_vit():
    from paddle_tpu_torch.models import vit

    cfg = dict(image_size=32, patch=8, d_model=32, d_ff=64, n_head=4,
               n_layer=2, n_class=10, dropout=0.0)
    return vit.build(cfg)[0]


@_example("stacked_lstm")
def _build_stacked_lstm():
    from paddle_tpu_torch.models import stacked_lstm

    cfg = dict(vocab=60, emb_dim=16, hidden=16, num_layers=2,
               num_classes=2, seq_len=10)
    return stacked_lstm.build(cfg)[0]


@_example("machine_translation")
def _build_mt():
    from paddle_tpu_torch.models import machine_translation

    cfg = dict(src_vocab=50, trg_vocab=50, emb_dim=16, hidden=16, seq_len=8)
    return machine_translation.build(cfg)[0]


def build_example(name, optimizer=True):
    """Build example ``name``'s (main, startup, loss) under fresh
    programs with the port's layers. ``optimizer=False`` skips the Adam
    step (forward-only program)."""
    import paddle_tpu_torch as fluid

    builder = EXAMPLE_BUILDERS[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            loss = builder()
            if optimizer:
                fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def analyze_example(name, batch_size=32, steps_per_call=1,
                    optimizer=True):
    """Build example ``name`` and price its train program. Returns
    (CostAnalysis, report dict)."""
    from paddle_tpu_torch.analysis.cost import CostAnalysis

    main, _startup, loss = build_example(name, optimizer=optimizer)
    ca = CostAnalysis(main, fetch_names=[loss.name], site="cli")
    dev = ca.device
    report = {
        "batch_size": batch_size,
        "steps_per_call": steps_per_call,
        "flops": ca.flops(batch_size),
        "bytes_moved": ca.bytes_moved(batch_size),
        "flops_form": ca.flops_poly().describe(),
        "predicted_seconds": ca.predicted_seconds(
            batch_size, steps_per_call=steps_per_call),
        "predicted_mfu": ca.predicted_mfu(
            batch_size, steps_per_call=steps_per_call),
        "device": {"kind": dev.kind, "source": dev.source,
                   "peak_flops": dev.peak_flops,
                   "dtype_peaks": dict(dev.dtype_peaks),
                   "peak_bandwidth": dev.peak_bandwidth,
                   "op_overhead": dev.op_overhead,
                   "call_overhead": dev.call_overhead},
        "by_op_type": ca.by_op_type(batch_size),
        "unruled_ops": sorted(set(ca.unruled)),
    }
    return ca, report


def _fmt_eng(x, unit):
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"),
                          (1e3, "K")):
        if x >= scale:
            return "%.2f %s%s" % (x / scale, suffix, unit)
    return "%.0f %s" % (x, unit)


def _print_report(name, report, top):
    print("== %s @ batch %d%s: predicted %.3f ms/step, MFU %.1f%% "
          "(device %s/%s)"
          % (name, report["batch_size"],
             " (K=%d window)" % report["steps_per_call"]
             if report["steps_per_call"] > 1 else "",
             report["predicted_seconds"] * 1e3,
             report["predicted_mfu"] * 100,
             report["device"]["kind"], report["device"]["source"]))
    print("   %s, %s moved | flops form: %s"
          % (_fmt_eng(report["flops"], "FLOP"),
             _fmt_eng(report["bytes_moved"], "B"),
             report["flops_form"]))
    for row in report["by_op_type"][:top]:
        print("   %-28s x%-3d %12s %12s %10.1f us"
              % (row["op_type"], row["count"],
                 _fmt_eng(row["flops"], "FLOP"),
                 _fmt_eng(row["bytes"], "B"),
                 row["seconds"] * 1e6))
    if report["unruled_ops"]:
        print("   (bytes-only ops without a FLOP rule: %s)"
              % ", ".join(report["unruled_ops"][:8]))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="roofline cost report over example model programs, "
                    "in the PyTorch port")
    p.add_argument("--model", nargs="*", choices=sorted(EXAMPLE_BUILDERS),
                   help="examples to analyze (default: all)")
    p.add_argument("--batch-size", type=int, default=32,
                   help="batch size to evaluate the polynomials at")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="train window K (the per-call host overhead "
                        "amortizes by K)")
    p.add_argument("--top", type=int, default=10,
                   help="op-type rows to list, most expensive first")
    p.add_argument("--per-op", action="store_true",
                   help="include the full per-op table (JSON only)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON document instead of text")
    p.add_argument("--no-optimizer", action="store_true",
                   help="analyze the forward-only program (no Adam step)")
    args = p.parse_args(argv)
    if args.batch_size < 1:
        p.error("--batch-size must be >= 1")
    if args.steps_per_call < 1:
        p.error("--steps-per-call must be >= 1")

    names = args.model or sorted(EXAMPLE_BUILDERS)
    out = {}
    for name in names:
        ca, report = analyze_example(
            name, batch_size=args.batch_size,
            steps_per_call=args.steps_per_call,
            optimizer=not args.no_optimizer)
        if args.per_op:
            report["table"] = ca.table(args.batch_size)
        out[name] = report
        if not args.json:
            _print_report(name, report, args.top)
    if args.json:
        json.dump(out, sys.stdout, indent=2)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
