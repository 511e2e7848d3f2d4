"""The port's high-level drivers held against the JAX package on the CPU:
``AsyncExecutor`` over the native MultiSlot feed (DeepFM at vocab 1000,
embedding 8), ``contrib.Trainer`` / ``Inferencer`` (the linear model of
tests/test_highlevel_api.py), the int8 ``Calibrator`` (the conv net of
tests/test_int8_calibration.py) and the book's recognize_digits fed
through ``PyReader``.

Both packages build one program each under ``unique_name.guard`` (the
same var names); the JAX startup's values move into the port's scope
with ``convert.params_from_jax`` (tests/torch_parity.py), so both
compute from the same weights. Tolerances: losses within 1e-5 (DeepFM's
Adam steps) or 1e-6 (the linear model's SGD), KL thresholds at the same
histogram bin, ``max`` scales within 1e-6 relative, the calibrated
program's answers within 1e-5. chip_smoke.py phase 20c's op check (the
card's ops held to the CPU's at the CPU's inputs) is driven on the CPU
against itself, with planted faults it must refuse.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.core.scope import scope_guard as jf_scope_guard
from torch_parity import build_both, jax_state, port_scope

CPU = pt.CPUPlace()


# ---------------------------------------------------------- AsyncExecutor
N_FIELDS, N_DENSE, VOCAB, EMB = 26, 13, 1000, 8


def _ctr_files(tmp_path, n_files=3, lines=24, seed=0):
    """Criteo-layout MultiSlot lines: 26 sparse ids, 13 dense values and
    the label, each slot as "<count> values..."."""
    rs = np.random.RandomState(seed)
    files = []
    for i in range(n_files):
        path = str(tmp_path / ("ctr-%d.txt" % i))
        with open(path, "w") as f:
            for _ in range(lines):
                ids = rs.randint(0, VOCAB, N_FIELDS)
                dense = rs.rand(N_DENSE)
                f.write("%d %s %d %s 1 %d\n" % (
                    N_FIELDS, " ".join(map(str, ids)), N_DENSE,
                    " ".join("%.6f" % v for v in dense), rs.randint(2)))
        files.append(path)
    return files


def _deepfm(pkg):
    from importlib import import_module

    ctr = import_module(pkg.__name__ + ".models.ctr")
    loss, _, _ = ctr.build("deepfm", n_fields=N_FIELDS, n_dense=N_DENSE,
                           vocab=VOCAB, emb_dim=EMB)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return [loss]


def test_async_executor_trains_deepfm_as_the_jax_package(tmp_path):
    from paddle_tpu.native.data_feed import SlotDesc as JSlot
    from paddle_tpu_torch.native.data_feed import SlotDesc as TSlot

    files = _ctr_files(tmp_path)
    progs = build_both(_deepfm)
    jmain, jstart, (jloss,) = progs["jax"]
    tmain, _, (tloss,) = progs["port"]
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    tscope = port_scope(jax_state(jmain, jscope), tmain)
    desc = {}
    for key, pkg, slot in (("jax", jf, JSlot), ("port", pt, TSlot)):
        desc[key] = pkg.DataFeedDesc(
            [slot("sparse_ids", "int64", N_FIELDS),
             slot("dense", "float32", N_DENSE),
             slot("label", "int64", 1)], batch_size=8)
    jae, tae = jf.AsyncExecutor(), pt.AsyncExecutor(CPU)
    # one file a call at one reader thread: each call's last loss is the
    # loss of that file's third batch, in file order
    for f in files:
        (jl,) = jae.run(jmain, desc["jax"], [f], thread_num=1,
                        fetch=[jloss], scope=jscope)
        (tl,) = tae.run(tmain, desc["port"], [f], thread_num=1,
                        fetch=[tloss], scope=tscope)
        np.testing.assert_allclose(np.asarray(tl), np.asarray(jl),
                                   rtol=0, atol=1e-5)
    for p in tmain.global_block().all_parameters():
        np.testing.assert_allclose(
            tscope.find_var(p.name).numpy(),
            np.asarray(jscope.find_var(p.name)), rtol=0, atol=1e-5)
    # four threads over all files: every batch once, the last loss finite
    (last,) = tae.run(tmain, desc["port"], files, thread_num=4,
                      fetch=[tloss], scope=tscope)
    assert np.isfinite(np.asarray(last)).all()


def test_async_executor_defaults_to_the_card():
    ae = pt.AsyncExecutor()
    assert ae._exe.device == torch.device("cuda", 0)
    assert not torch.cuda.is_initialized()


# ------------------------------------------------------ Trainer/Inferencer
def _linear_train(pkg):
    def train_func():
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, size=1, param_attr=pkg.ParamAttr(name="tw"))
        return [pkg.layers.mean(pkg.layers.square_error_cost(pred, y))]

    return train_func


def _linear_infer(pkg):
    def infer_func():
        x = pkg.layers.data("x", [4])
        return pkg.layers.fc(x, size=1, param_attr=pkg.ParamAttr(name="tw"))

    return infer_func


W = np.linspace(-1, 1, 4).astype("float32")[:, None]


def _linear_reader():
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(8):
        X = rs.randn(16, 4).astype("float32")
        batches.append([(X[i], X[i] @ W) for i in range(16)])
    return lambda: iter(batches)


def test_trainer_and_inferencer_match_the_jax_package(tmp_path):
    from paddle_tpu.contrib import EndStepEvent as JEnd
    from paddle_tpu.contrib import Inferencer as JInferencer
    from paddle_tpu.contrib import Trainer as JTrainer
    from paddle_tpu_torch.contrib import EndStepEvent, Inferencer, Trainer

    reader = _linear_reader()
    jt = JTrainer(_linear_train(jf), lambda: jf.optimizer.SGD(0.1))
    tt = Trainer(_linear_train(pt), lambda: pt.optimizer.SGD(0.1),
                 place=CPU)
    # the port starts from the JAX package's weights
    for n, t in pt.convert.params_from_jax(
            jax_state(jt.train_program, jt.scope), tt.train_program,
            torch.device("cpu")).items():
        tt.scope.set_var(n, t)
    seen = {"jax": [], "port": []}

    def handler(key, end):
        def h(event):
            if isinstance(event, end):
                seen[key].append(float(np.asarray(event.metrics[0])
                                       .reshape(-1)[0]))
        return h

    jt.train(3, handler("jax", JEnd), reader, ["x", "y"])
    tt.train(3, handler("port", EndStepEvent), reader, ["x", "y"])
    assert len(seen["port"]) == 24 and seen["port"][-1] < 0.3 * \
        seen["port"][0]
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.test(reader, ["x", "y"]),
                               jt.test(reader, ["x", "y"]), rtol=0,
                               atol=1e-6)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.save_params(jdir)
    tt.save_params(tdir)
    X = np.random.RandomState(1).randn(8, 4).astype("float32")
    (want,) = JInferencer(_linear_infer(jf), jdir).infer({"x": X})
    (got,) = Inferencer(_linear_infer(pt), tdir, place=CPU).infer({"x": X})
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    # the port reloads the JAX package's params too (the same names)
    (cross,) = Inferencer(_linear_infer(pt), jdir, place=CPU).infer(
        {"x": X})
    np.testing.assert_allclose(cross, np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, X @ W, atol=0.4)


def test_trainer_stops_saves_and_refuses_parallel(tmp_path):
    from paddle_tpu_torch.contrib import (BeginEpochEvent, BeginStepEvent,
                                          EndEpochEvent, Trainer)

    events = []

    def handler(event):
        events.append(type(event).__name__)
        if isinstance(event, BeginStepEvent) and event.step >= 1:
            t.stop()

    t = Trainer(_linear_train(pt), lambda: pt.optimizer.SGD(0.1), place=CPU)
    t.train(2, handler, _linear_reader(), ["x", "y"])
    assert events == ["BeginEpochEvent", "BeginStepEvent", "EndStepEvent",
                      "BeginStepEvent", "EndStepEvent"]
    assert BeginEpochEvent(0).epoch == EndEpochEvent(0).epoch == 0
    with pt.scope_guard(t.scope):  # the JAX package's saves read it too
        t.save_inference_model(str(tmp_path / "m"), ["x"], [0])
        prog, feeds, fetches = pt.io.load_inference_model(
            str(tmp_path / "m"), t.exe)
    assert feeds == ["x"] and len(fetches) == 1
    # parallel=True was refused before the port had CompiledProgram; it
    # now trains through one, on the CPU positions of its place
    tp = Trainer(_linear_train(pt), lambda: pt.optimizer.SGD(0.1),
                 place=CPU, parallel=True)
    assert isinstance(tp._compiled, pt.CompiledProgram)
    tp.train(1, lambda event: None, _linear_reader(), ["x", "y"])
    assert tp._compiled._engine.mesh.device == torch.device("cpu")


def test_trainer_and_inferencer_default_to_the_card(monkeypatch):
    from paddle_tpu_torch.contrib import Inferencer, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_linear_train(pt), lambda: pt.optimizer.SGD(0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Inferencer(_linear_infer(pt), "unused")


# -------------------------------------------------------------- Calibrator
def _conv_net(pkg):
    x = pkg.layers.data("x", [1, 8, 8])
    conv = pkg.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                             act="relu")
    flat = pkg.layers.reshape(conv, [-1, 4 * 8 * 8])
    return [pkg.layers.fc(flat, size=3, act="softmax")]


def _calib_setup():
    """Both packages' inference programs of the conv net and their scopes,
    the port's holding the JAX startup's weights (the fc weight spread by
    6, as tests/test_int8_calibration.py spreads it)."""
    progs = build_both(_conv_net, seed=0)
    jmain, jstart, (jpred,) = progs["jax"]
    tmain, _, (tpred,) = progs["port"]
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    w = next(p.name for p in jmain.global_block().all_parameters()
             if "fc" in p.name and p.name.endswith(".w_0"))
    jscope.set_var(w, np.asarray(jscope.find_var(w)) * 6.0)
    tscope = port_scope(jax_state(jmain, jscope), tmain)
    return (dict(main=jmain.clone(for_test=True), pred=jpred, exe=jexe,
                 scope=jscope),
            dict(main=tmain.clone(for_test=True), pred=tpred,
                 exe=pt.Executor(CPU), scope=tscope))


def _batches(n=4, bs=8):
    rs = np.random.RandomState(0)
    return [rs.rand(bs, 1, 8, 8).astype("float32") for _ in range(n)]


@pytest.mark.parametrize("algo", ["max", "KL"])
def test_calibrator_matches_the_jax_package(algo):
    from paddle_tpu.contrib.int8_inference import Calibrator as JCal
    from paddle_tpu_torch.contrib.int8_inference import Calibrator as TCal

    j, t = _calib_setup()
    cal = {}
    for key, side, cls, guard in (("jax", j, JCal, jf_scope_guard),
                                  ("port", t, TCal, pt.scope_guard)):
        with guard(side["scope"]):
            c = cls(side["main"], scope=side["scope"], algo=algo, bins=512)
            for xb in _batches():
                c.sample_data(side["exe"], feed={"x": xb},
                              fetch_list=[side["pred"]])
        cal[key] = c
    assert cal["port"].sampling_vars == cal["jax"].sampling_vars
    js, ts = cal["jax"].scales(), cal["port"].scales()
    assert sorted(js) == sorted(ts)
    for name in js:
        if algo == "max":
            assert abs(ts[name] - js[name]) <= 1e-6 * abs(js[name]), name
        else:
            # the threshold sits at the same bin of the same edge
            bin_w = cal["jax"]._hist_edge[name] / 512
            assert abs(ts[name] - js[name]) < 0.5 * bin_w, name
    xb = _batches(n=1)[0]
    outs = []
    for key, side in (("jax", j), ("port", t)):
        q = cal[key].generate_calibrated_program()
        kinds = [op.type for op in q.global_block().ops]
        assert kinds.count("fake_quantize_abs_max") >= 3
        (out,) = side["exe"].run(q, feed={"x": xb},
                                 fetch_list=[side["pred"]],
                                 scope=side["scope"])
        outs.append(np.asarray(out))
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)


def test_calibrator_save_int8_model_roundtrip(tmp_path):
    from paddle_tpu_torch.contrib.int8_inference import Calibrator

    _, t = _calib_setup()
    with pt.scope_guard(t["scope"]):
        calib = Calibrator(t["main"], scope=t["scope"], algo="max")
        for xb in _batches(n=2):
            calib.sample_data(t["exe"], feed={"x": xb},
                              fetch_list=[t["pred"]])
        out = str(tmp_path / "int8_model")
        calib.save_int8_model(out, t["exe"], ["x"], [t["pred"]])
        prog2, feeds, fetches = pt.io.load_inference_model(out, t["exe"])
        xb = _batches(n=1)[0]
        (q_out,) = t["exe"].run(prog2, feed={feeds[0]: xb},
                                fetch_list=fetches, scope=t["scope"])
        (q_ref,) = t["exe"].run(calib.generate_calibrated_program(),
                                feed={"x": xb}, fetch_list=[t["pred"]],
                                scope=t["scope"])
        (fp_out,) = t["exe"].run(t["main"], feed={"x": xb},
                                 fetch_list=[t["pred"]], scope=t["scope"])
    assert "fake_quantize_abs_max" in [op.type for op in
                                       prog2.global_block().ops]
    np.testing.assert_array_equal(q_out, q_ref)
    np.testing.assert_allclose(q_out, fp_out, atol=0.05)


def test_calibrator_error_paths():
    from paddle_tpu_torch.contrib.int8_inference import Calibrator

    _, t = _calib_setup()
    calib = Calibrator(t["main"], scope=t["scope"], algo="max")
    with pytest.raises(RuntimeError, match="sample_data"):
        calib.scales()
    with pytest.raises(ValueError, match="algo"):
        Calibrator(pt.Program(), scope=pt.Scope(), algo="entropy2")


def _chip_smoke():
    import os
    import sys
    from importlib import import_module

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return import_module("chip_smoke")


def test_chip_smoke_holds_int8_ops_to_the_cpus(tmp_path):
    """chip_smoke.py phase 20c's op check, driven on the CPU against
    itself: every op of the saved int8 program at the CPU's inputs holds,
    the planted faults (a conv's and a fake-quant op's output off by
    1e-3) are refused, the ops run in turn give the Predictor's answer,
    and the same fault run through the whole program moves it."""
    from paddle_tpu_torch.contrib.int8_inference import Calibrator

    cs = _chip_smoke()
    _, t = _calib_setup()
    with pt.scope_guard(t["scope"]):
        calib = Calibrator(t["main"], scope=t["scope"], algo="KL")
        for xb in _batches(n=2):
            calib.sample_data(t["exe"], feed={"x": xb},
                              fetch_list=[t["pred"]])
        out = str(tmp_path / "int8_model")
        calib.save_int8_model(out, t["exe"], ["x"], [t["pred"]])
    req = {"x": _batches(n=1, bs=1)[0]}
    block, ops, scope, feeds, fetch = cs._int8_program(pt, out)
    assert feeds == ["x"]
    conv = [i for i, op in enumerate(ops) if op.type == "conv2d"][-1]
    quant = [i for i, op in enumerate(ops)
             if op.type.startswith("fake_quantize")][-1]
    env = cs._int8_env(ops, scope, req)
    by_type, refused, planted = cs._int8_ops_held(
        block, ops, env, torch.device("cpu"), fault_at=(conv, quant))
    assert refused == []
    assert by_type["conv2d"] == dict(ops=1, worst=0.0)
    assert by_type["fake_quantize_abs_max"]["ops"] == 4
    assert [(p["op"], p["refused"]) for p in planted] == [
        (conv, True), (quant, True)]
    config = pt.inference.AnalysisConfig(out)
    config.disable_gpu()
    want = pt.inference.create_paddle_predictor(config).run(req)[0]
    np.testing.assert_array_equal(env[fetch[0]].numpy(), want)

    def fault(i, op, e):
        if i == conv:
            n = op.output_names()[0]
            e[n] = e[n] * (1 + cs.CALIB_FAULT)

    moved = cs._run_int8(block, ops, cs._int8_env(ops, scope, req), fault)
    assert np.abs(moved[fetch[0]].numpy() - want).max() > 0


class _Op:
    """The parts of an op ``_op_departure`` reads."""

    def __init__(self, type):
        self.type = type
        self.inputs = {"InScale": ["s"]} if type.startswith("fake") else {}
        self.attrs = {"bit_length": 8}

    def input(self, slot):
        return self.inputs.get(slot, [])


@pytest.mark.parametrize("case,held", [
    ("conv at rounding", True), ("conv off by 1e-3", False),
    ("one-level flips, few", True), ("two-level flip", False),
    ("one-level flips, many", False), ("ints differ", False)])
def test_chip_smoke_op_departure_rules(case, held):
    """The bounds of phase 20c's op check: a float output within 1e-4 of
    its abs max (rounding passes, 1e-3 fails); a fake-quant output equal
    but for one-level flips in at most 1e-4 of its elements; integers
    equal."""
    cs = _chip_smoke()
    rs = np.random.RandomState(0)
    env = {"s": torch.tensor([2.54])}
    step = 2.54 / 127
    b = torch.from_numpy(rs.randn(200_000)).float()
    q = torch.round(b / step) * step
    a = {
        "conv at rounding": lambda: b * (1 + 1e-6),
        "conv off by 1e-3": lambda: b * (1 + 1e-3),
        "one-level flips, few": lambda: q + step * (
            torch.arange(q.numel()) % 20_000 == 7),
        "two-level flip": lambda: q + 2 * step * (torch.arange(q.numel())
                                                  == 7),
        "one-level flips, many": lambda: q + step * (
            torch.arange(q.numel()) % 1000 == 7),
        "ints differ": lambda: torch.arange(5) + (torch.arange(5) == 3),
    }[case]()
    op = _Op("conv2d" if case.startswith("conv") or case == "ints differ"
             else "fake_quantize_abs_max")
    ref = {"conv at rounding": b, "conv off by 1e-3": b,
           "ints differ": torch.arange(5)}.get(case, q)
    assert cs._op_departure(op, a, ref, env)[1] is held


# ------------------------------------------------- the book's mnist, fed
def _mnist(pkg):
    from importlib import import_module

    mnist = import_module(pkg.__name__ + ".models.mnist")
    loss, acc, feeds = mnist.build("cnn")
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return [loss, acc]


def test_recognize_digits_through_pyreader_matches_the_jax_package():
    """The book's recognize_digits the Fluid way, at its widths (20 and
    50 filters) on a few batches of 16: the JAX package fed by its
    DataFeeder, the port by ``PyReader`` (its CPU place), from the same
    weights; losses within 1e-5."""
    import paddle_tpu.dataset  # noqa: F401

    progs = build_both(_mnist)
    jmain, jstart, (jloss, _) = progs["jax"]
    tmain, _, (tloss, _) = progs["port"]
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    tscope = port_scope(jax_state(jmain, jscope), tmain)
    texe = pt.Executor(CPU)
    jfeeds = [jmain.global_block().var(n) for n in ("img", "label")]
    feeder = jf.DataFeeder(jfeeds)
    want = [float(np.asarray(jexe.run(jmain, feed=feeder.feed(b),
                                      fetch_list=[jloss], scope=jscope)[0]))
            for b in jf.batch(jf.dataset.mnist.train(n=64), 16)()]
    reader = pt.layers.PyReader(
        feed_list=[tmain.global_block().var(n) for n in ("img", "label")],
        capacity=2)
    reader.decorate_sample_list_generator(
        pt.batch(pt.dataset.mnist.train(n=64), 16), places=CPU)
    got = [float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                          scope=tscope)[0])
           for feed in reader()]
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
