#!/usr/bin/env python
"""Build, inspect and validate deployable artifacts of the PyTorch port
from the command line: the port of tools/export_artifact.py
(``paddle_tpu_torch.export``).

    python tools/torch_export_artifact.py --model mnist --out mnist.pdz
    python tools/torch_export_artifact.py --model mnist --out m.pdz \\
        --buckets 1,8 --no-aot --cpu
    python tools/torch_export_artifact.py --inspect mnist.pdz
    python tools/torch_export_artifact.py --validate mnist.pdz [--cpu]

``--model`` freezes one of the model-zoo forward-only programs at the
tiny configs of tools/lint_program.py's examples, for the models the
port lowers (``EXAMPLE_BUILDERS`` below; lint_program's builders import
the JAX package, so the port keeps its own table of the same configs):
startup-initialized weights, inference rewrite, live-config optimize
with TV forced on, params checksummed, winner-table slice, memory
polynomial and (unless ``--no-aot``) one ``torch.export`` program per
``--buckets`` entry, exported on the card, or on the CPU with
``--cpu``.

``--inspect`` prints the manifest without rehydrating anything: format
version, sections with their sha256 prefixes and sizes, the frozen
config_key, per-var param checksums and the predicted peak bytes per
bucket. ``--validate`` runs the full load-time validation ladder
(container, config_key, section checksums, TV digest, per-var param
checksums, and the AOT section's platform) for the card, or with
``--cpu`` for the CPU, and exits 1 on any skew — the pre-deploy gate
a rollout runs before pointing ``ReplicaRouter.roll`` at a file.

Exit code: 0 = built/clean, 1 = skew or corruption detected, 2 = bad
usage.
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
    programs. ``optimizer=False`` skips the Adam step (forward-only
    program)."""
    import paddle_tpu_torch as fluid

    builder = EXAMPLE_BUILDERS[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            loss = builder()
            if optimizer:
                fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _place(args):
    import paddle_tpu_torch as fluid

    return fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0)


def _build(args) -> int:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import export

    main, startup, loss = build_example(args.model, optimizer=False)
    scope = fluid.Scope()
    place = _place(args)
    with fluid.scope_guard(scope):
        fluid.Executor(place).run(startup, scope=scope)
        feed_names = sorted(
            v.name for v in main.global_block().vars.values()
            if v.is_data)
        path = export.save_artifact(
            main, args.out, feed_names=feed_names,
            fetch_names=[loss.name], scope=scope,
            batch_sizes=tuple(args.buckets),
            aot=False if args.no_aot else None,
            name=args.model, place=place)
    size = os.path.getsize(path)
    print("wrote %s (%d bytes): model=%s feeds=%s fetch=%s buckets=%s"
          % (path, size, args.model, ",".join(feed_names), loss.name,
             ",".join(str(b) for b in args.buckets) or "-"))
    return 0


def _inspect(path: str) -> int:
    from paddle_tpu_torch.export.format import read_artifact

    manifest, zf = read_artifact(path)
    try:
        sizes = {i.filename: i.file_size for i in zf.infolist()}
    finally:
        zf.close()
    print("artifact %s" % path)
    print("  name: %s" % manifest.get("name"))
    print("  format_version: %s" % manifest.get("format_version"))
    print("  feeds: %s  fetches: %s  buckets: %s"
          % (",".join(manifest.get("feed_names") or []) or "-",
             ",".join(manifest.get("fetch_names") or []) or "-",
             ",".join(str(b) for b in manifest.get("batch_sizes") or [])
             or "-"))
    print("  optimize_level: %s  exact_numerics: %s"
          % (manifest.get("optimize_level"),
             manifest.get("exact_numerics")))
    print("  config_key: %s" % json.dumps(manifest.get("config_key")))
    if manifest.get("tv_digest"):
        print("  tv_digest: %s" % manifest["tv_digest"][:16])
    if manifest.get("aot_skipped"):
        print("  aot_skipped: %s" % manifest["aot_skipped"])
    print("  sections:")
    checks = manifest.get("checksums") or {}
    for s in manifest.get("sections") or []:
        print("    %-14s %8d bytes  sha256 %s..."
              % (s, sizes.get("section/%s" % s, 0),
                 (checks.get(s) or "")[:16]))
    params = manifest.get("params") or {}
    print("  params: %d vars" % len(params))
    for n in sorted(params):
        rec = params[n]
        print("    %-32s %-10s %-18s sha256 %s..."
              % (n, rec.get("dtype"), "x".join(
                  str(d) for d in rec.get("shape") or []) or "scalar",
                 (rec.get("sha256") or "")[:16]))
    pred = manifest.get("predicted_bytes") or {}
    if pred:
        print("  predicted peak bytes:")
        for b in sorted(pred, key=int):
            print("    batch %-6s %d" % (b, pred[b]))
    return 0


def _validate(path: str, place) -> int:
    from paddle_tpu_torch import export

    try:
        art = export.load_artifact(path, place=place)
    except export.ArtifactSkewError as e:
        print("SKEW (%s): %s" % (e.reason, e), file=sys.stderr)
        return 1
    except export.ArtifactError as e:
        print("INVALID: %s" % e, file=sys.stderr)
        return 1
    print("OK %s: program=%s params=%d tuned_imported=%d aot=%s"
          % (path, "yes" if art.program is not None else "no",
             len(art.params), art.tuned_imported,
             ",".join(str(b) for b in sorted(art.aot)) or "-"))
    for section, reason in art.degraded:
        print("  degraded: %s (%s) -> recompute at serve time"
              % (section, reason))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        description="build / inspect / validate deployable artifacts")
    p.add_argument("--model", choices=sorted(EXAMPLE_BUILDERS),
                   help="freeze this model-zoo example (forward-only)")
    p.add_argument("--out", help="artifact path to write (with --model)")
    p.add_argument("--buckets", default="1,8",
                   help="comma-separated batch-size buckets "
                        "(default: 1,8)")
    p.add_argument("--no-aot", action="store_true",
                   help="skip the AOT section")
    p.add_argument("--cpu", action="store_true",
                   help="build (and export) or validate for the CPU "
                        "rather than the card")
    p.add_argument("--inspect", metavar="PATH",
                   help="print an artifact's manifest and exit")
    p.add_argument("--validate", metavar="PATH",
                   help="run load-time validation; exit 1 on skew")
    args = p.parse_args(argv)

    if args.inspect:
        return _inspect(args.inspect)
    if args.validate:
        return _validate(args.validate, _place(args))
    if not args.model or not args.out:
        p.error("either --model + --out, --inspect or --validate "
                "is required")
    try:
        args.buckets = [int(b) for b in args.buckets.split(",") if b]
    except ValueError:
        p.error("--buckets takes comma-separated ints, got %r"
                % args.buckets)
    return _build(args)


if __name__ == "__main__":
    sys.exit(main())
