"""Deployable artifacts in the port (``paddle_tpu_torch.export``), held to
the contracts of tests/test_export_artifact.py on the CPU:

* Round trip: a port-frozen mnist, ctr, stacked_lstm and small serving
  BERT round-trip bitwise against the from-scratch executor, with the AOT
  section (``torch.export``) serving.
* Cold start: load + the first covered batch move no plan-cache miss, no
  pass-pipeline run and no tuner miss; ``seed_plan`` installs without a
  miss.
* The AOT section: its graph holds the K1 / K4 operators
  (``paddle_tpu_torch::flash_attention_fwd``, ``::layernorm_residual_fwd``)
  and nothing that reads a data pointer; it serves, counted; a failing
  export raises where the section is required (the card) and degrades,
  recorded, on the CPU; a section for another platform raises when
  loaded for the card.
* Skew safety, every refusal counted; a missing AOT section degrades and
  counts; racing writers never corrupt the file.
* Rolling upgrade with the router's default factory
  (``DecodeEngine.from_artifact``), a crash mid-roll, and
  ``from_artifact`` refusing an artifact with no serving section.
* Across packages: a JAX-frozen artifact (``aot=False``) serves in the
  port within 1e-5 of the JAX package's Predictor, and both packages'
  ``params`` sections hold the same arrays, byte for byte.
* The CLI (tools/torch_export_artifact.py).
"""

import io
import json
import os
import sys
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import export
from paddle_tpu_torch.observe import families as fam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
try:
    from torch_export_artifact import build_example
finally:
    sys.path.pop(0)

CPU = pt.CPUPlace()
# JAX-frozen artifacts served in the port: the same f32 program on two
# frameworks' CPU kernels
JAX_ATOL = 1e-5
BERT_CFG = dict(d_model=32, d_ff=64, n_head=4, n_layer=2, vocab=100,
                type_vocab=2, max_length=64, dropout=0.1)
BERT_SEQ = 16


def _feed_for(main, batch, seed=0):
    rng = np.random.RandomState(seed)
    feed = {}
    for var in main.global_block().vars.values():
        if not var.is_data:
            continue
        shape = [batch if (s is None or s < 0) else int(s)
                 for s in (var.shape or [batch])]
        if var.dtype.startswith(("int", "uint")):
            feed[var.name] = rng.randint(0, 2, shape).astype("int64")
        else:
            feed[var.name] = rng.uniform(-1, 1, shape).astype("float32")
    return feed


def _freeze(main, startup, fetch, path, feed, batch, **kw):
    """Run the from-scratch reference, freeze. Returns (ref, path)."""
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    ref, = exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
    export.save_artifact(main, path, feed_names=sorted(feed),
                         fetch_names=[fetch.name], scope=scope,
                         batch_sizes=(batch,), place=CPU, **kw)
    return np.asarray(ref), path


def _serving_bert():
    """A small BERT's serving program (is_test) and its encoder output."""
    from paddle_tpu_torch.models import bert

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        bert.build(BERT_CFG, seq_len=BERT_SEQ, max_mask=4, is_test=True)
    blk = main.global_block()
    gather = next(op for op in blk.ops if op.type == "gather")
    reshape = next(op for op in blk.ops if op.type == "reshape2"
                   and gather.input("X")[0] in op.output("Out"))
    enc = blk.var(reshape.input("X")[0])
    feed = _feed_for(main, 4)
    feed = {n: feed[n] for n in ("src_ids", "sent_ids", "input_mask")}
    feed["input_mask"] = np.ones_like(feed["input_mask"])
    feed["input_mask"][1, 11:] = 0.0
    return main, startup, enc, feed


def _freeze_zoo(model, path, batch=4):
    if model == "bert":
        main, startup, out, feed = _serving_bert()
    else:
        main, startup, out = build_example(model, optimizer=False)
        feed = _feed_for(main, batch)
    ref, path = _freeze(main, startup, out, path, feed, batch, name=model)
    return ref, feed, path


@pytest.fixture
def flash_path(monkeypatch):
    """The small BERT's attention through the flash operator (K1), as
    S = 512 takes it."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")


# --------------------------------------------------------- round trip
@pytest.mark.parametrize("model", ["mnist", "ctr", "bert", "stacked_lstm"])
def test_roundtrip_bitwise_parity_zoo(model, tmp_path, flash_path):
    ref, feed, path = _freeze_zoo(model, str(tmp_path / "m.pdz"))
    art = export.load_artifact(path, place=CPU)
    assert sorted(art.aot) == [4]
    out = np.asarray(art.predictor().run(feed)[0])
    np.testing.assert_array_equal(out, ref)
    assert art.degraded == []


def test_exact_numerics_freezes_unoptimized_program(tmp_path):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        out = pt.layers.fc(x, size=4)
    main.exact_numerics = True
    feed = {"x": np.random.RandomState(3).randn(4, 8).astype("float32")}
    ref, path = _freeze(main, startup, out, str(tmp_path / "e.pdz"), feed,
                        4)
    art = export.load_artifact(path, place=CPU)
    assert art.manifest["exact_numerics"] is True
    assert art.manifest["optimize_level"] == 0
    assert art.rewrite_log == []
    assert art.program.exact_numerics is True
    np.testing.assert_array_equal(art.predictor().run(feed)[0], ref)


# --------------------------------------------------------- cold start
def _opt_total():
    return sum(fam.OPTIMIZER_PROGRAMS.labels(level=lv).value
               for lv in ("1", "2"))


def test_cold_start_moves_zero_compile_counters(tmp_path):
    ref, feed, path = _freeze_zoo("mnist", str(tmp_path / "m.pdz"))
    miss0 = fam.EXECUTOR_CACHE_MISSES.value
    opt0 = _opt_total()
    tune0 = fam.KERNEL_TUNER_MISSES.value
    seeded0 = fam.ARTIFACT_PLANS_SEEDED.value
    ok0 = fam.ARTIFACT_LOADS.labels(outcome="ok").value
    art = export.load_artifact(path, place=CPU)
    pred = art.predictor()
    out = np.asarray(pred.run(feed)[0])
    # the seeded plan path too (the AOT section set aside)
    pred._aot = {}
    np.testing.assert_array_equal(pred.run(feed)[0], out)
    np.testing.assert_array_equal(out, ref)
    assert fam.EXECUTOR_CACHE_MISSES.value == miss0
    assert _opt_total() == opt0
    assert fam.KERNEL_TUNER_MISSES.value == tune0
    assert fam.ARTIFACT_PLANS_SEEDED.value == seeded0 + 1
    assert fam.ARTIFACT_LOADS.labels(outcome="ok").value == ok0 + 1


def test_seed_plan_installs_without_miss():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[6], dtype="float32")
        out = pt.layers.fc(x, size=3)
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    feed = {"x": np.zeros((2, 6), "float32")}
    exe = pt.Executor(CPU)
    assert exe.seed_plan(main, feed, [out], scope=scope) is True
    assert exe.seed_plan(main, feed, [out], scope=scope) is False
    miss0 = fam.EXECUTOR_CACHE_MISSES.value
    hit0 = fam.EXECUTOR_CACHE_HITS.value
    exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert fam.EXECUTOR_CACHE_MISSES.value == miss0
    assert fam.EXECUTOR_CACHE_HITS.value == hit0 + 1


# ------------------------------------------------------------ the AOT
def _graph_targets(module):
    return [n.target for g in module.modules()
            if isinstance(g, torch.fx.GraphModule)
            for n in g.graph.nodes if n.op == "call_function"]


def test_aot_section_serves_and_holds_the_kernel_operators(
        tmp_path, flash_path, monkeypatch):
    """On the card's route (the fused layer norm launching K4, forced
    here onto its plain version) the exported graph calls K1 and K4 as
    operators, one node per launch, and otherwise only ATen: nothing
    that reads a data pointer; it serves bitwise the seeded plan path
    and the from-scratch executor, and counts its calls."""
    from paddle_tpu_torch.ops import fused_ops

    monkeypatch.setattr(fused_ops, "_on_card", lambda t: True)
    ref, feed, path = _freeze_zoo("bert", str(tmp_path / "b.pdz"))
    art = export.load_artifact(path, place=CPU)
    assert sorted(art.aot) == [4] and art.aot_meta["platform"] == "cpu"
    # the section carries no weights: the params are inputs, and the
    # export's example inputs (the params among them) are not saved
    with zipfile.ZipFile(path) as zf:
        inner = zipfile.ZipFile(io.BytesIO(zf.read("section/aot")))
    assert torch.export.load(io.BytesIO(
        inner.read("bucket_4.pt2"))).example_inputs is None
    targets = _graph_targets(art.aot[4].module)
    names = [str(t) for t in targets]
    n = BERT_CFG["n_layer"]
    assert names.count("paddle_tpu_torch.flash_attention_fwd.default") == n
    assert names.count(
        "paddle_tpu_torch.layernorm_residual_fwd.default") == 2 * n + 1
    for t in targets:
        ns = getattr(t, "namespace", None)
        assert ns in ("aten", "paddle_tpu_torch") or \
            getattr(t, "__module__", "").startswith(
                ("_operator", "torch._higher_order_ops")), t
    aot0 = fam.ARTIFACT_AOT_CALLS.value
    pred = art.predictor()
    out = np.asarray(pred.run(feed)[0])
    assert fam.ARTIFACT_AOT_CALLS.value == aot0 + 1
    np.testing.assert_array_equal(out, ref)
    pred._aot = {}
    np.testing.assert_array_equal(pred.run(feed)[0], out)
    # the CPU's own route replays the unfused pair: K1 alone is an
    # operator there
    monkeypatch.setattr(fused_ops, "_on_card", lambda t: False)
    ref, feed, path = _freeze_zoo("bert", str(tmp_path / "c.pdz"))
    art = export.load_artifact(path, place=CPU)
    names = [str(t) for t in _graph_targets(art.aot[4].module)]
    assert names.count("paddle_tpu_torch.flash_attention_fwd.default") == n
    assert "paddle_tpu_torch.layernorm_residual_fwd.default" not in names
    np.testing.assert_array_equal(art.predictor().run(feed)[0], ref)


def _host_sync_lowering(monkeypatch):
    """Make ``relu`` read a tensor's value on the host: what export
    cannot trace."""
    from paddle_tpu_torch.core.registry import get_op

    opdef = get_op("relu")
    orig = opdef.lowering

    def syncing(ctx, ins, attrs):
        if float(ins["X"][0].sum()) > 1e30:
            raise AssertionError("unreachable")
        return orig(ctx, ins, attrs)

    monkeypatch.setattr(opdef, "lowering", syncing)


def test_failing_aot_export_raises_where_required(tmp_path, monkeypatch):
    """The card's export is strict: a bucket that does not export raises
    ``ArtifactError`` naming the bucket and the op, never a silent plan
    path. On the CPU the JAX package's best effort holds: recorded, and
    the load counts the absent section."""
    from paddle_tpu_torch.export import artifact

    main, startup, loss = build_example("mnist", optimizer=False)
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    feed = _feed_for(main, 2)
    _host_sync_lowering(monkeypatch)
    prog = main.clone(for_test=True)
    params = {v.name: scope.find_var(v.name).numpy()
              for v in main.list_vars() if v.persistable}
    with pytest.raises(export.ArtifactError,
                       match=r"bucket 2 does not export at op 'relu'"):
        artifact._aot_blob(prog, sorted(feed), [loss.name], params, (2,),
                           {}, torch.device("cpu"), strict=True)
    path = str(tmp_path / "m.pdz")
    export.save_artifact(main, path, feed_names=sorted(feed),
                         fetch_names=[loss.name], scope=scope,
                         batch_sizes=(2,), place=CPU)
    art = export.load_artifact(path, place=CPU)
    # (the frozen program runs relu inside a fused_elementwise op)
    assert "bucket 2 does not export at op 'fused_elementwise'" in \
        art.manifest["aot_skipped"]
    assert ("aot", "absent") in art.degraded


def test_aot_section_for_another_platform_raises_for_the_card(tmp_path):
    ref, feed, path = _freeze_zoo("mnist", str(tmp_path / "m.pdz"))
    with pytest.raises(export.ArtifactError, match="platform 'cpu'"):
        export.load_artifact(path, place=pt.CUDAPlace(0))
    assert not torch.cuda.is_initialized()


def test_impure_program_degrades_and_is_recorded(tmp_path):
    """A program whose dropout draws at run time (a training-built BERT)
    has no AOT section: recorded at save, counted at load."""
    main, startup, loss = build_example("bert", optimizer=False)
    feed = _feed_for(main, 2)
    _, path = _freeze(main, startup, loss, str(tmp_path / "b.pdz"), feed, 2)
    d0 = fam.ARTIFACT_DEGRADED.labels(section="aot", reason="absent").value
    art = export.load_artifact(path, place=CPU)
    assert "draws randomness" in art.manifest["aot_skipped"]
    assert fam.ARTIFACT_DEGRADED.labels(
        section="aot", reason="absent").value == d0 + 1


# --------------------------------------------------------- skew safety
def _fc_artifact(tmp_path, name="a.pdz"):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        h = pt.layers.fc(x, size=16, act="relu")
        out = pt.layers.fc(h, size=4, act="softmax")
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    path = str(tmp_path / name)
    export.save_artifact(main, path, feed_names=["x"],
                         fetch_names=[out.name], scope=scope,
                         batch_sizes=(2,), aot=False)
    return path


def _rewrite(path, out_path, edit):
    with zipfile.ZipFile(path) as zf:
        data = {n: zf.read(n) for n in zf.namelist()}
    edit(data)
    with zipfile.ZipFile(out_path, "w") as zf:
        for n, b in data.items():
            zf.writestr(n, b)
    return out_path


def _skew_count(reason):
    return fam.ARTIFACT_SKEW.labels(reason=reason).value


def _refused(path, reason, match=None):
    c0 = _skew_count(reason)
    with pytest.raises(export.ArtifactSkewError, match=match) as e:
        export.load_artifact(path, place=CPU)
    assert e.value.reason == reason
    assert _skew_count(reason) == c0 + 1


def test_truncated_file_refused_and_counted(tmp_path):
    path = _fc_artifact(tmp_path)
    raw = open(path, "rb").read()
    trunc = str(tmp_path / "t.pdz")
    with open(trunc, "wb") as f:
        f.write(raw[:len(raw) // 2])
    l0 = fam.ARTIFACT_LOADS.labels(outcome="corrupt").value
    _refused(trunc, "corrupt")
    assert fam.ARTIFACT_LOADS.labels(outcome="corrupt").value == l0 + 1


def test_flipped_param_byte_refused(tmp_path):
    import hashlib

    path = _fc_artifact(tmp_path)

    def edit(data):
        with np.load(io.BytesIO(data["section/params"])) as npz:
            arrs = {k: npz[k].copy() for k in npz.files}
        arrs[sorted(arrs)[0]].flat[0] += 1.0
        buf = io.BytesIO()
        np.savez(buf, **arrs)
        data["section/params"] = buf.getvalue()
        m = json.loads(data["manifest.json"])
        m["checksums"]["params"] = hashlib.sha256(
            data["section/params"]).hexdigest()
        data["manifest.json"] = json.dumps(m).encode()

    _refused(_rewrite(path, str(tmp_path / "bad.pdz"), edit),
             "param_checksum")


def test_section_checksum_mismatch_refused(tmp_path):
    path = _fc_artifact(tmp_path)

    def edit(data):
        data["section/program"] = data["section/program"] + b" "

    _refused(_rewrite(path, str(tmp_path / "bad.pdz"), edit),
             "section_checksum")


def test_stale_config_key_refused(tmp_path, monkeypatch):
    path = _fc_artifact(tmp_path)
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE_QUANT", "1")
    _refused(path, "config_key", match="frozen under config")


def test_tampered_tv_digest_refused(tmp_path):
    path = _fc_artifact(tmp_path)

    def edit(data):
        m = json.loads(data["manifest.json"])
        m["tv_digest"] = "0" * 64
        data["manifest.json"] = json.dumps(m).encode()

    _refused(_rewrite(path, str(tmp_path / "bad.pdz"), edit), "tv_digest")


def test_future_format_version_refused_with_message(tmp_path):
    path = _fc_artifact(tmp_path)

    def edit(data):
        m = json.loads(data["manifest.json"])
        m["format_version"] = export.FORMAT_VERSION + 41
        data["manifest.json"] = json.dumps(m).encode()

    _refused(_rewrite(path, str(tmp_path / "bad.pdz"), edit),
             "future_version", match="format version")


def test_future_aot_section_version_degrades(tmp_path):
    ref, feed, path = _freeze_zoo("mnist", str(tmp_path / "m.pdz"))

    def edit(data):
        m = json.loads(data["manifest.json"])
        m["section_versions"]["aot"] = 2
        data["manifest.json"] = json.dumps(m).encode()

    bad = _rewrite(path, str(tmp_path / "v.pdz"), edit)
    d0 = fam.ARTIFACT_DEGRADED.labels(section="aot", reason="version").value
    art = export.load_artifact(bad, place=CPU)
    assert art.aot == {} and ("aot", "version") in art.degraded
    assert fam.ARTIFACT_DEGRADED.labels(
        section="aot", reason="version").value == d0 + 1
    np.testing.assert_array_equal(art.predictor().run(feed)[0], ref)


def test_missing_aot_section_degrades_and_counts(tmp_path):
    path = _fc_artifact(tmp_path)  # saved with aot=False
    d0 = fam.ARTIFACT_DEGRADED.labels(section="aot", reason="absent").value
    art = export.load_artifact(path, place=CPU)
    assert ("aot", "absent") in art.degraded
    assert art.aot == {}
    assert fam.ARTIFACT_DEGRADED.labels(
        section="aot", reason="absent").value == d0 + 1
    out = art.predictor().run({"x": np.zeros((2, 8), "float32")})
    assert np.asarray(out[0]).shape == (2, 4)


def test_concurrent_writers_never_corrupt_the_file(tmp_path):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        out = pt.layers.fc(x, size=2)
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    path = str(tmp_path / "race.pdz")
    errors = []

    def save():
        try:
            export.save_artifact(main, path, feed_names=["x"],
                                 fetch_names=[out.name], scope=scope,
                                 aot=False)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=save) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    art = export.load_artifact(path, place=CPU)
    assert sorted(art.params) == sorted(
        v.name for v in main.list_vars() if v.persistable)
    assert not [n for n in os.listdir(str(tmp_path)) if ".tmp." in n]


def test_tuned_slice_skips_foreign_choices_and_keeps_live_winners():
    from paddle_tpu_torch.kernels import tune

    tune.reset()
    try:
        tune.set_entry("attention", (64, 64), {"choice": "composed",
                                               "cfg": []})
        e0 = tune.epoch()
        n = tune.import_entries({
            "attention|64,64": {"choice": "cuda", "cfg": []},
            "attention|32,32": {"choice": "cuda", "cfg": []},
            "attention|16,16": {"choice": "pallas", "cfg": []},
            "layernorm_residual|8,8": {"choice": "pallas", "cfg": [8]},
            "bad": "entry"})
        assert n == 1 and tune.epoch() == e0 + 1
        assert tune.peek("attention", (64, 64))["choice"] == "composed"
        assert tune.peek("attention", (32, 32))["source"] == "artifact"
        assert tune.peek("attention", (16, 16)) is None
        assert tune.export_entries(keys=["attention|"]) == {
            "attention|64,64": {"choice": "composed", "cfg": []},
            "attention|32,32": {"choice": "cuda", "cfg": []}}
        assert tune.import_entries({}) == 0 and tune.epoch() == e0 + 1
    finally:
        tune.reset()


# ---------------------------------------------------------------- CLI
def test_cli_build_inspect_validate(tmp_path, capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_export_artifact as cli
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "cli.pdz")
    assert cli.main(["--model", "mnist", "--out", out,
                     "--buckets", "2", "--cpu"]) == 0
    assert cli.main(["--inspect", out]) == 0
    text = capsys.readouterr().out
    assert "format_version: 1" in text
    assert "config_key" in text and "params: 6 vars" in text
    assert "aot " in text
    assert cli.main(["--validate", out, "--cpu"]) == 0
    assert "aot=2" in capsys.readouterr().out
    # a CPU-exported section is refused for the card
    assert cli.main(["--validate", out]) == 1
    bad = str(tmp_path / "bad.pdz")
    with open(out, "rb") as f:
        raw = f.read()
    with open(bad, "wb") as f:
        f.write(raw[: len(raw) // 3])
    assert cli.main(["--validate", bad, "--cpu"]) == 1


# ------------------------------------------------------ rolling upgrade
ROLL_CFG = dict(d_model=32, d_ff=64, n_head=2, n_layer=1, vocab=64,
                max_length=32, dropout=0.0)
ROLL_MAX_LEN = 32


def _gpt_params(seed_shift=0.0):
    from paddle_tpu_torch.models import gpt

    prog, start = pt.Program(), pt.Program()
    scope = pt.Scope()
    with pt.program_guard(prog, start):
        _logits, cache_names = gpt.build_decode_step(
            ROLL_CFG, batch=1, max_len=ROLL_MAX_LEN)
    pt.Executor(CPU).run(start, scope=scope)
    params = {n: scope.find_var(n).numpy()
              for n in prog.global_block().vars
              if n.startswith("gpt_") and n not in cache_names
              and scope.find_var(n) is not None}
    if seed_shift:
        rng = np.random.RandomState(7)
        params = {
            n: (v + rng.normal(0.0, seed_shift, v.shape).astype(v.dtype)
                if np.issubdtype(v.dtype, np.floating) else v)
            for n, v in params.items()}
    return params


def _engine(params, **kw):
    from paddle_tpu_torch.serving import DecodeEngine

    return DecodeEngine(ROLL_CFG, params=params, max_len=ROLL_MAX_LEN,
                        place=CPU, **kw)


@pytest.fixture(scope="module")
def roll_fleet(tmp_path_factory):
    v1 = _gpt_params()
    v2 = _gpt_params(seed_shift=0.25)
    path = str(tmp_path_factory.mktemp("roll") / "gpt_v2.pdz")
    export.save_artifact(
        None, path, params=v2,
        serving=dict(cfg=ROLL_CFG, b_max=2, max_len=ROLL_MAX_LEN),
        name="gpt-v2")
    prompt = np.arange(1, 7, dtype="int64")
    outs = {}
    for tag, params in (("v1", v1), ("v2", v2)):
        eng = _engine(params, b_max=1).start()
        try:
            outs[tag] = eng.submit(prompt, 4).result(timeout=240)
        finally:
            eng.stop()
    assert not np.array_equal(outs["v1"], outs["v2"])
    return dict(v1=v1, path=path, prompt=prompt,
                out_v1=outs["v1"], out_v2=outs["v2"])


def test_roll_replaces_fleet_with_drain_exactly_once(roll_fleet):
    """The router's default factory (``DecodeEngine.from_artifact``)
    rolls a two-replica v1 fleet to the v2 artifact with drain: every
    request in flight ends exactly once, served by v1 or v2; then the
    whole fleet serves v2."""
    from paddle_tpu_torch.serving import ReplicaRouter

    v1, path = roll_fleet["v1"], roll_fleet["path"]
    prompt = roll_fleet["prompt"]

    def v1_factory(idx):
        return _engine(v1, b_max=2, queue_capacity=32)

    router = ReplicaRouter(v1_factory, n_replicas=2, poll_s=0.05,
                           max_readmissions=3)
    try:
        for _ in range(2):
            np.testing.assert_array_equal(
                router.submit(prompt, 4).result(timeout=240),
                roll_fleet["out_v1"])
        rolled0 = fam.ARTIFACT_ROLL_REPLICAS.value
        ok0 = fam.ARTIFACT_ROLLS.labels(outcome="ok").value
        done = []
        reqs = [router.submit(prompt, 4) for _ in range(6)]
        for r in reqs:
            r.add_done_callback(lambda _r: done.append(_r))
        rolled = router.roll(path, queue_capacity=32, place=CPU)
        outs = [r.result(timeout=240) for r in reqs]
        assert len(done) == len(reqs)
        assert {id(r) for r in done} == {id(r) for r in reqs}
        for o in outs:
            assert (np.array_equal(o, roll_fleet["out_v1"])
                    or np.array_equal(o, roll_fleet["out_v2"])), o
        assert rolled == 2
        assert fam.ARTIFACT_ROLL_REPLICAS.value == rolled0 + 2
        assert fam.ARTIFACT_ROLLS.labels(outcome="ok").value == ok0 + 1
        for _ in range(2):
            np.testing.assert_array_equal(
                router.submit(prompt, 4).result(timeout=240),
                roll_fleet["out_v2"])
    finally:
        router.close()


def test_roll_crash_mid_roll_recovers_at_new_version(roll_fleet):
    from paddle_tpu_torch.serving import DecodeEngine, ReplicaRouter

    v1, path = roll_fleet["v1"], roll_fleet["path"]
    prompt = roll_fleet["prompt"]

    def v1_factory(idx):
        return _engine(v1, b_max=2, queue_capacity=32)

    router = ReplicaRouter(v1_factory, n_replicas=2, poll_s=0.05,
                           max_readmissions=3)
    try:
        router.submit(prompt, 4).result(timeout=240)
        art = export.load_artifact(path, place=CPU)
        killed = []

        def v2_factory(idx):
            if not killed:
                victim = router.replicas[1]
                victim.engine._error = RuntimeError("chaos: mid-roll")
                killed.append(victim.idx)
            return DecodeEngine.from_artifact(art, queue_capacity=32,
                                              place=CPU)

        restarts0 = sum(r.restarts for r in router.replicas)
        rolled = router.roll(None, engine_factory=v2_factory)
        assert killed == [1]
        assert rolled == 2
        assert sum(r.restarts for r in router.replicas) >= restarts0 + 2

        def _fleet_serves_v2():
            outs = [router.submit(prompt, 4).result(timeout=240)
                    for _ in range(4)]
            return all(np.array_equal(o, roll_fleet["out_v2"])
                       for o in outs)

        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if all(r.engine.alive() and not r.draining
                   for r in router.replicas) and _fleet_serves_v2():
                break
            time.sleep(0.1)
        else:
            pytest.fail("fleet never converged to v2 after mid-roll crash")
    finally:
        router.close()


def test_from_artifact_without_serving_section_refuses(tmp_path):
    from paddle_tpu_torch.serving import DecodeEngine

    path = _fc_artifact(tmp_path)
    d0 = fam.ARTIFACT_DEGRADED.labels(section="serving",
                                      reason="absent").value
    with pytest.raises(export.ArtifactError, match="serving"):
        DecodeEngine.from_artifact(export.load_artifact(path, place=CPU))
    assert fam.ARTIFACT_DEGRADED.labels(
        section="serving", reason="absent").value == d0 + 1


# ------------------------------------------------------ across packages
def _jax_mnist():
    """The JAX package's mnist (lint_program's example), started."""
    import paddle_tpu as jf
    from paddle_tpu.core.scope import Scope as JScope

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from lint_program import build_example as jax_build
    finally:
        sys.path.pop(0)
    main, startup, loss = jax_build("mnist", optimizer=False)
    scope = JScope()
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    return main, loss, scope


def test_jax_frozen_artifact_serves_in_the_port(tmp_path):
    from paddle_tpu import export as jexport

    main, loss, scope = _jax_mnist()
    feed = _feed_for(main, 4)
    path = str(tmp_path / "jax.pdz")
    jexport.save_artifact(main, path, feed_names=sorted(feed),
                          fetch_names=[loss.name], scope=scope,
                          batch_sizes=(4,), aot=False, name="mnist")
    want = np.asarray(jexport.load_artifact(path).predictor().run(feed)[0])
    art = export.load_artifact(path, place=CPU)
    assert ("aot", "absent") in art.degraded
    got = np.asarray(art.predictor().run(feed)[0])
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)


def test_params_section_is_the_jax_packages_for_the_same_params(tmp_path):
    """Both packages write the params section as ``np.savez`` of the same
    host arrays: the manifests' per-var records agree and every member
    of the two npz files is byte for byte the same."""
    from paddle_tpu import export as jexport

    main, loss, scope = _jax_mnist()
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable}
    jpath, tpath = str(tmp_path / "j.pdz"), str(tmp_path / "t.pdz")
    serving = dict(cfg={"note": "params only"})
    jexport.save_artifact(None, jpath, params=params, serving=serving)
    export.save_artifact(None, tpath, params=params, serving=serving)
    blobs, records = [], []
    for p in (jpath, tpath):
        with zipfile.ZipFile(p) as zf:
            blobs.append(zf.read("section/params"))
            records.append(json.loads(zf.read("manifest.json"))["params"])
    assert records[0] == records[1]
    members = []
    for b in blobs:
        with zipfile.ZipFile(io.BytesIO(b)) as zf:
            members.append({n: zf.read(n) for n in zf.namelist()})
    assert members[0] == members[1] and len(members[0]) == len(params)
