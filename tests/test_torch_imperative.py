"""Dygraph in the port (``paddle_tpu_torch.imperative``), held to the
contracts of tests/test_imperative.py, test_imperative_capture.py and
test_imperative_parity.py on the CPU:

* the eager tape: math, backward, the tape against graph mode
  (``append_backward``), a training loop, PyLayer;
* every ``imperative.nn`` layer's eager forward and gradients against the
  JAX package's on the same inputs and params (the same layouts; f32 on
  the CPU in both, rtol 1e-5 / atol 1e-6 as the JAX package's own parity
  test, conv2d's sums 1e-5 atol);
* ``imperative.jit``: a capture is bitwise its eager steps (losses,
  params and the generator chain), an encoder with flash attention,
  layer norms and dropout too; the level-2 capture within float
  tolerance; retrace reasons, LRU eviction, the config-key flip,
  ``as_predictor`` bitwise, ``autotune=True`` raising; an eager train
  loop against the JAX package's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu import imperative as jimp
from paddle_tpu.imperative import nn as jnn
from paddle_tpu_torch import imperative, observe
from paddle_tpu_torch.imperative import nn as inn
from paddle_tpu_torch.imperative import optimizer as iopt
from paddle_tpu_torch.imperative import trace_op
from paddle_tpu_torch.imperative.capture import CaptureError

CPU = pt.CPUPlace()
# the JAX package's eager tape and the port's on the same f32 inputs: one
# lowering each, summed in another order (its own parity test's bounds)
RTOL, ATOL = 1e-5, 1e-6
CONV_ATOL = 1e-5


def _value(name, **labels):
    for s in observe.snapshot()["metrics"][name]["samples"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0.0


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=atol)


def _leaf(arr, stop=True):
    v = imperative.to_variable(arr)
    v.stop_gradient = stop
    return v


def _loss(out, op=trace_op):
    sq = op("square", {"X": [out]}, {})["Out"][0]
    return op("mean", {"X": [sq]}, {})["Out"][0]


# ------------------------------------------------------------ the tape
def test_guard_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with imperative.guard():
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imperative.to_variable(np.ones(2, np.float32))
    with imperative.guard(place=CPU):
        assert imperative.to_variable(np.ones(2)).value.device.type == "cpu"


def test_eager_math_and_numpy():
    with imperative.guard(place=CPU):
        a = imperative.to_variable(np.array([1.0, 2.0], np.float32))
        b = imperative.to_variable(np.array([3.0, 4.0], np.float32))
        c = a * b + 2.0
        np.testing.assert_allclose(c.numpy(), [5.0, 10.0])
        assert c.shape == (2,) and c.dtype == "float32"
        # numpy's float64 and int64 arrive as jnp.asarray makes them
        assert imperative.to_variable(np.ones(2)).dtype == "float32"
        assert imperative.to_variable(np.arange(3)).dtype == "int32"
        with pytest.raises(OverflowError):
            imperative.to_variable(np.array([2 ** 40]))


def test_backward_simple_chain():
    with imperative.guard(place=CPU):
        x = imperative.to_variable(np.array([[1.0, 2.0]], np.float32))
        y = x * x
        s = trace_op("reduce_sum", {"X": [y]}, {"reduce_all": True})["Out"][0]
        s.backward()
        np.testing.assert_allclose(x.gradient(), [[2.0, 4.0]])
        assert imperative.get_tracer().tape == []


def test_backward_matches_graph_mode():
    from paddle_tpu_torch.core.backward import append_backward

    X = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    W = np.random.RandomState(1).randn(3, 2).astype(np.float32)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        xv = pt.layers.data(name="x", shape=[3], dtype="float32")
        wv = pt.layers.create_parameter(
            [3, 2], "float32", name="w",
            default_initializer=pt.initializer.NumpyArrayInitializer(W))
        loss = pt.layers.mean(pt.layers.square(pt.layers.matmul(xv, wv)))
        append_backward(loss)
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    g_graph, = exe.run(main, feed={"x": X}, fetch_list=["w@GRAD"],
                       scope=scope)
    with imperative.guard(place=CPU):
        wd = imperative.to_variable(W)
        out = trace_op("matmul", {"X": [_leaf(X)], "Y": [wd]}, {})["Out"][0]
        _loss(out).backward()
        np.testing.assert_array_equal(wd.gradient(), g_graph)


def test_layer_training_loop():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 4).astype(np.float32)
    Y = (X @ np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)) + 0.3
    with imperative.guard(place=CPU, seed=0):
        fc = inn.FC("fc", size=1)
        losses = []
        for _ in range(20):
            diff = fc(_leaf(X)) - _leaf(Y)
            loss = _loss(diff)
            loss.backward()
            for p in fc.parameters():
                p.value = p.value - 0.1 * p._grad
            fc.clear_gradients()
            losses.append(float(loss.numpy()))
    assert losses[-1] < losses[0] * 0.1, losses


def test_gru_unit_has_no_lowering_yet():
    """``GRUUnit`` traces ``gru_unit``, which the port now lowers (the
    sequence slice, ROADMAP A9; the name is this test's from before it
    did): its eager forward and its grads equal the JAX package's
    dygraph on the same params, and it trains under the port's Adam."""
    rs = np.random.RandomState(4)
    X = rs.randn(3, 12).astype(np.float32)
    H = rs.randn(3, 4).astype(np.float32)

    def run(layer, imp):
        xv, hv = imp.to_variable(X), imp.to_variable(H)
        layer(xv, hv)  # makes the params
        imp.get_tracer().tape.clear()
        xv = imp.to_variable(X)
        xv.stop_gradient = False
        hv = imp.to_variable(H)
        hv.stop_gradient = False
        h, reset, gate = layer(xv, hv)
        _loss(h, imp.trace_op).backward()
        return [h.numpy(), reset.numpy(), gate.numpy(), xv.gradient(),
                hv.gradient(), layer._w.gradient(), layer._b.gradient()]

    for origin in (False, True):
        j, t = _both(lambda nn, _o=origin: nn.GRUUnit(
            "gru", size=12, origin_mode=_o), run)
        for a, b in zip(j, t):
            _close(b, a)

    with imperative.guard(place=CPU, seed=0):
        gru = inn.GRUUnit("gru", size=12)
        opt = iopt.Adam(learning_rate=0.05)
        losses = []
        for _ in range(5):
            h, _, _ = gru(_leaf(X), _leaf(H))
            loss = _loss(h)
            loss.backward()
            opt.minimize(loss, parameter_list=gru.parameters())
            gru.clear_gradients()
            losses.append(float(loss.numpy()))
    assert losses[-1] < losses[0], losses


def test_py_layer_custom_forward_backward():
    class TripleButGradIsTen(imperative.PyLayer):
        @staticmethod
        def forward(x):
            return 3.0 * x

        @staticmethod
        def backward(dout):
            return 10.0 * dout

    with imperative.guard(place=CPU):
        x = imperative.to_variable(np.array([[1.0, 2.0]], dtype=np.float32))
        y = TripleButGradIsTen()(x)
        np.testing.assert_allclose(y.numpy(), [[3.0, 6.0]])
        (y * 2.0).backward()
        np.testing.assert_allclose(x.gradient(), [[20.0, 20.0]])


def test_py_layer_multi_input_and_unused_output():
    class WeightedSum(imperative.PyLayer):
        @staticmethod
        def forward(a, b):
            return 2.0 * a + 3.0 * b

        @staticmethod
        def backward(dout):
            return 2.0 * dout, 3.0 * dout

    class TwoOut(imperative.PyLayer):
        @staticmethod
        def forward(x):
            return 2.0 * x, 3.0 * x

        @staticmethod
        def backward(d0, d1):
            assert d0 is not None and d1 is not None
            return 2.0 * d0 + 3.0 * d1

    with imperative.guard(place=CPU):
        a = imperative.to_variable(np.ones((2, 2), np.float32))
        b = imperative.to_variable(np.ones((2, 2), np.float32))
        out = WeightedSum()(a, b)
        np.testing.assert_allclose(out.numpy(), 5.0 * np.ones((2, 2)))
        out.backward()
        np.testing.assert_allclose(a.gradient(), 2.0 * np.ones((2, 2)))
        np.testing.assert_allclose(b.gradient(), 3.0 * np.ones((2, 2)))
        x = imperative.to_variable(np.ones((2,), np.float32))
        first, second = TwoOut()(x)
        del second
        first.backward()
        np.testing.assert_allclose(x.gradient(), 2.0 * np.ones((2,)))
        # a host callback cannot enter a captured Program
        with pytest.raises(CaptureError, match="host callback"):
            imperative.jit(lambda v: WeightedSum()(v, v))(_leaf(
                np.ones((2, 2), np.float32)))


# ------------------------------------------- layers against JAX's tape
def _both(make, run, seed=3):
    """Build a layer in each package from the same global numpy RNG
    state, copy the JAX layer's params into the port's (same layouts),
    run ``run(layer, imperative_module)`` in each and return both
    results."""
    np.random.seed(seed)
    with jimp.guard():
        jl = make(jnn)
        jres = run(jl, jimp)
    np.random.seed(seed)
    with imperative.guard(place=CPU):
        tl = make(inn)
        for tp, jp in zip(tl.parameters(), jl.parameters()):
            tp.value = torch.from_numpy(np.array(jp.numpy()))
        tres = run(tl, imperative)
    return jres, tres


def _eager(layer, imp, x, grads_of):
    xv = imp.to_variable(x)
    xv.stop_gradient = False
    out = layer(xv)
    _loss(out, imp.trace_op).backward()
    return [out.numpy(), xv.gradient()] + [p.gradient()
                                            for p in grads_of(layer)]


def test_fc_matches_the_jax_package():
    X = np.random.RandomState(0).rand(4, 6).astype(np.float32)

    def run(layer, imp):
        layer(imp.to_variable(X))  # makes the params
        imp.get_tracer().tape.clear()
        return _eager(layer, imp, X, lambda lay: [lay._w, lay._b])

    j, t = _both(lambda nn: nn.FC("fc", 3, act="relu"), run)
    for a, b in zip(j, t):
        _close(b, a)


def test_conv2d_pool2d_match_the_jax_package():
    X = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)

    class Net:
        def __init__(self, nn):
            self.conv = nn.Conv2D("conv", num_channels=3, num_filters=4,
                                  filter_size=3, padding=1, act="relu")
            self.pool = nn.Pool2D("pool", pool_size=2, pool_stride=2,
                                  pool_type="avg")

        def __call__(self, x):
            return self.pool(self.conv(x))

        def parameters(self):
            return self.conv.parameters()

    j, t = _both(Net, lambda lay, imp: _eager(
        lay, imp, X, lambda n: n.conv.parameters()))
    for a, b in zip(j, t):
        _close(b, a, atol=CONV_ATOL)


def test_batch_norm_matches_the_jax_package():
    X = np.random.RandomState(2).randn(4, 3, 5, 5).astype(np.float32)

    def run(layer, imp):
        res = _eager(layer, imp, X, lambda lay: [lay._scale, lay._bias])
        return res + [layer._mean.numpy(), layer._variance.numpy()]

    j, t = _both(lambda nn: nn.BatchNorm("bn", num_channels=3), run)
    for a, b in zip(j, t):
        _close(b, a)


def test_embedding_matches_the_jax_package():
    ids = np.array([[1], [3], [3]], np.int64)

    def run(layer, imp):
        out = layer(imp.to_variable(ids))
        _loss(out, imp.trace_op).backward()
        return [out.numpy(), layer._w.gradient()]

    j, t = _both(lambda nn: nn.Embedding("emb", size=(10, 4)), run)
    for a, b in zip(j, t):
        _close(b, a)
    assert np.abs(t[1][0]).sum() == 0 and np.abs(t[1][3]).sum() > 0


def test_adam_train_loop_matches_the_jax_package():
    """The eager MLP trained by ``optimizer.Adam`` for 5 steps from the
    same init in both packages (no dropout: the packages' random streams
    differ by design)."""
    rs = np.random.RandomState(0)
    X = rs.rand(8, 16).astype(np.float32)
    Y = rs.rand(8, 1).astype(np.float32)

    def train(imp, nn, opt):
        np.random.seed(42)
        with (imp.guard() if imp is jimp else imp.guard(place=CPU)):
            fc1, fc2 = nn.FC("fc1", 16, act="relu"), nn.FC("fc2", 1)
            adam = opt.Adam(learning_rate=1e-2)
            losses = []
            for _ in range(5):
                x, y = imp.to_variable(X), imp.to_variable(Y)
                x.stop_gradient = y.stop_gradient = True
                d = imp.trace_op("elementwise_sub",
                                 {"X": [fc2(fc1(x))], "Y": [y]}, {})["Out"][0]
                loss = _loss(d, imp.trace_op)
                loss.backward()
                adam.step(fc1.parameters() + fc2.parameters())
                losses.append(float(np.asarray(loss.numpy()).reshape(())))
            return losses, [np.asarray(p.numpy()) for p in
                            fc1.parameters() + fc2.parameters()]

    from paddle_tpu.imperative import optimizer as jopt

    jl, jp = train(jimp, jnn, jopt)
    tl, tp = train(imperative, inn, iopt)
    _close(tl, jl)
    for a, b in zip(tp, jp):
        _close(a, b)


# ------------------------------------------------------------- capture
def _mlp_step(fc1, fc2, adam):
    def step(x, y):
        h = trace_op("dropout", {"X": [fc1(x)]},
                     {"dropout_prob": 0.3, "is_test": False})["Out"][0]
        d = trace_op("elementwise_sub", {"X": [fc2(h)], "Y": [y]},
                     {})["Out"][0]
        loss = _loss(d)
        loss.backward()
        adam.step(fc1.parameters() + fc2.parameters())
        return loss
    return step


def _run_train(n_steps, captured, exact=True):
    rs = np.random.RandomState(0)
    X = rs.rand(8, 16).astype(np.float32)
    Y = rs.rand(8, 1).astype(np.float32)
    np.random.seed(42)
    with imperative.guard(place=CPU, seed=7):
        fc1 = inn.FC("fc1", 16, act="relu")
        fc2 = inn.FC("fc2", 1)
        adam = iopt.Adam(learning_rate=1e-2)
        step = _mlp_step(fc1, fc2, adam)
        fn = imperative.jit(step, exact_numerics=exact) if captured else step
        losses = [fn(_leaf(X), _leaf(Y)).numpy() for _ in range(n_steps)]
        params = [p.numpy() for p in fc1.parameters() + fc2.parameters()]
        rng = imperative.get_tracer()._rng.get_state().numpy()
    return losses, params, rng, (fn if captured else None)


def test_captured_train_step_bitwise_eager():
    N = 5
    e_losses, e_params, e_rng, _ = _run_train(N, captured=False)
    c_losses, c_params, c_rng, cap = _run_train(N, captured=True)
    assert cap.stats["captures"] == 1
    assert cap.stats["hits"] == N - 1
    for a, b in zip(e_losses, c_losses):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(e_params, c_params):
        assert a.tobytes() == b.tobytes()
    assert e_rng.tobytes() == c_rng.tobytes()


def test_level2_capture_within_tolerance_and_same_chain():
    """``exact_numerics=False``: the level-2 pipeline runs the captured
    step (on the CPU the fused ops replay their constituents), the chain
    advances as eagerly."""
    e_losses, e_params, e_rng, _ = _run_train(4, captured=False)
    f_losses, f_params, f_rng, cap = _run_train(4, captured=True,
                                                exact=False)
    assert cap._last_entry.program.exact_numerics is False
    _close(f_losses, e_losses)
    for a, b in zip(f_params, e_params):
        _close(a, b)
    assert e_rng.tobytes() == f_rng.tobytes()


def test_capture_telemetry_and_pass_stats():
    cap0 = _value("paddle_imperative_captures_total")
    hit0 = _value("paddle_imperative_cache_hits_total")
    _, _, _, cap = _run_train(3, captured=True)
    assert _value("paddle_imperative_captures_total") == cap0 + 1
    assert _value("paddle_imperative_cache_hits_total") == hit0 + 2
    rows = cap._last_entry.pass_stats
    assert rows and all(
        {"pass", "ops_before", "ops_after"} <= set(r) for r in rows)
    assert cap._last_entry.predicted_bytes > 0


def test_bucketed_retrace_counted_in_telemetry():
    b0 = _value("paddle_imperative_retraces_total", reason="bucket")
    with imperative.guard(place=CPU):
        fc = inn.FC("fc", 4)

        @imperative.jit(buckets=[8, 16])
        def fwd(x):
            return fc(x)

        def run(n):
            return fwd(_leaf(np.ones((n, 6), np.float32)))

        assert run(5).shape[0] == 5
        run(7)
        assert fwd.stats["captures"] == 1 and fwd.stats["hits"] == 1
        assert run(12).shape[0] == 12
        assert fwd.stats["captures"] == 2
        assert fwd.stats["retraces"]["bucket"] == 1
        assert _value("paddle_imperative_retraces_total",
                      reason="bucket") == b0 + 1
        run(13)
        assert fwd.stats["captures"] == 2


def test_branch_guard_mismatch_retraces():
    with imperative.guard(place=CPU):
        @imperative.jit
        def fn(x):
            s = trace_op("reduce_sum", {"X": [x]},
                         {"reduce_all": True})["Out"][0]
            if float(s) > 0:
                return trace_op("relu", {"X": [x]}, {})["Out"][0]
            return trace_op("square", {"X": [x]}, {})["Out"][0]

        def run(arr):
            return fn(_leaf(arr.astype(np.float32))).numpy()

        pos = np.array([[1.0, 2.0]])
        neg = np.array([[-1.0, -2.0]])
        np.testing.assert_allclose(run(pos), [[1.0, 2.0]])
        assert fn.stats["captures"] == 1
        np.testing.assert_allclose(run(neg), [[1.0, 4.0]])
        assert fn.stats["captures"] == 2
        assert fn.stats["retraces"]["branch"] == 1
        np.testing.assert_allclose(run(pos), [[1.0, 2.0]])
        assert fn.stats["captures"] == 2 and fn.stats["hits"] == 1


def test_cache_lru_eviction_counted():
    ev0 = _value("paddle_imperative_cache_evictions_total")
    with imperative.guard(place=CPU):
        @imperative.jit(cache_size=2)
        def fwd(x):
            return trace_op("square", {"X": [x]}, {})["Out"][0]

        for shape in [(2, 3), (3, 3), (4, 3)]:
            fwd(_leaf(np.ones(shape, np.float32)))
        assert fwd.stats["captures"] == 3 and fwd.cache_len == 2
        assert _value("paddle_imperative_cache_evictions_total") == ev0 + 1
        fwd(_leaf(np.ones((2, 3), np.float32)))
        assert fwd.stats["captures"] == 4


def test_cache_size_env_knob(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CAPTURE_CACHE_SIZE", "1")
    assert imperative.jit(lambda x: x)._cap == 1
    monkeypatch.setenv("PADDLE_TPU_CAPTURE_CACHE_SIZE", "0")
    with pytest.raises(ValueError):
        imperative.jit(lambda x: x)


def test_config_key_flip_retraces(monkeypatch):
    with imperative.guard(place=CPU):
        @imperative.jit
        def fwd(x):
            return trace_op("square", {"X": [x]}, {})["Out"][0]

        def run():
            return fwd(_leaf(np.ones((2, 2), np.float32)))

        run()
        run()
        assert fwd.stats == {"captures": 1, "hits": 1,
                             "retraces": {"shape": 0, "bucket": 0,
                                          "branch": 0, "config": 0}}
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE_QUANT", "1")
        run()
        assert fwd.stats["captures"] == 2
        assert fwd.stats["retraces"]["config"] == 1


def test_autotune_raises_naming_the_missing_tuner(monkeypatch, tmp_path):
    """``autotune=True`` (or ``PADDLE_TPU_CAPTURE_AUTOTUNE=1``) no longer
    raises: the capture goes through the unified autotuner (its window
    decision lands in the tuner's table) and replays as before."""
    from paddle_tpu_torch.kernels import tune

    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", "1")
    tune.reset()
    x = np.arange(4, dtype=np.float32).reshape(2, 2)
    try:
        with imperative.guard(place=CPU):
            fwd = imperative.jit(
                lambda x: trace_op("square", {"X": [x]}, {})["Out"][0],
                autotune=True)
            first = fwd(_leaf(x)).numpy()
            again = fwd(_leaf(x)).numpy()
            assert fwd.stats["captures"] == 1 and fwd.stats["hits"] == 1
            assert first.tobytes() == again.tobytes() == (x * x).tobytes()
            assert any(k.startswith("train_window|")
                       for k in tune.export_entries())
            tune.reset()
            monkeypatch.setenv("PADDLE_TPU_CAPTURE_AUTOTUNE", "1")
            fwd = imperative.jit(
                lambda x: trace_op("square", {"X": [x]}, {})["Out"][0])
            assert fwd(_leaf(x)).numpy().tobytes() == first.tobytes()
            assert any(k.startswith("train_window|")
                       for k in tune.export_entries())
    finally:
        tune.reset()


def test_captured_inference_serves_through_predictor_bitwise():
    np.random.seed(3)
    X = np.random.RandomState(1).rand(4, 6).astype(np.float32)
    with imperative.guard(place=CPU):
        fc1 = inn.FC("fc1", 8, act="relu")
        fc2 = inn.FC("fc2", 3)

        @imperative.jit
        def fwd(x):
            return fc2(fc1(x))

        eager_out = fwd(_leaf(X)).numpy()
        pred = fwd.as_predictor(warmup_batch_sizes=[4, 8])
    out, = pred.run([X])
    assert np.asarray(out).tobytes() == eager_out.tobytes()
    X7 = np.random.RandomState(2).rand(6, 6).astype(np.float32)
    out7, = pred.run([X7])
    assert out7.shape == (6, 3)
    with imperative.guard(place=CPU):
        fc = inn.FC("fc", 1)
        adam = iopt.Adam()

        @imperative.jit
        def train(x):
            loss = trace_op("reduce_mean", {"X": [fc(x)]}, {})["Out"][0]
            loss.backward()
            adam.step(fc.parameters())
            return loss

        train(_leaf(X))
        with pytest.raises(CaptureError):
            train.as_predictor()


def test_capture_outside_guard_raises():
    # a tensor argument (a numpy one would first be placed on the card,
    # the default place outside a guard)
    cap = imperative.jit(lambda x: x)
    with pytest.raises(CaptureError):
        cap(torch.ones((2, 2)))


def test_learning_rate_is_read_and_replaced_as_a_tensor():
    with imperative.guard(place=CPU):
        adam = iopt.Adam(learning_rate=1e-3)
        before = adam._lr.value
        adam.learning_rate = 5e-4
        assert adam._lr.value is not before
        assert adam.learning_rate == np.float32(5e-4)
        assert before.item() == np.float32(1e-3)


# ------------------------------------------------- an encoder, captured
ENC = dict(d=32, heads=4, ffn=64, layers=2, vocab=50, seq=16, batch=2,
           mask=3)


def _encoder(seed, p_drop=0.1):
    """A small post-norm encoder on the eager tape: embeddings, layers of
    q / k / v / out FCs, ``fused_attention`` (key-pad bias, dropout),
    layer norms, a gelu FFN, and an MLM loss over gathered positions."""
    np.random.seed(seed)
    d, h = ENC["d"], ENC["heads"]
    dh = d // h
    emb = inn.Embedding("word", [ENC["vocab"], d])
    lays = [{k: inn.FC("%s%d" % (k, i), n, num_flatten_dims=2)
             for k, n in (("q", d), ("k", d), ("v", d), ("o", d),
                          ("f1", ENC["ffn"]), ("f2", d))}
            for i in range(ENC["layers"])]
    head = inn.FC("head", ENC["vocab"])
    ln = imperative.Layer("ln")
    norms = [(ln.create_parameter("s%d" % i, (d,), initializer=1.0),
              ln.create_parameter("b%d" % i, (d,), initializer=0.0))
             for i in range(2 * ENC["layers"])]
    B, S = ENC["batch"], ENC["seq"]

    def norm(x, sb):
        return trace_op("layer_norm", {"X": [x], "Scale": [sb[0]],
                                       "Bias": [sb[1]]},
                        {"begin_norm_axis": 2})["Y"][0]

    def drop(x):
        return trace_op("dropout", {"X": [x]},
                        {"dropout_prob": p_drop, "is_test": False})["Out"][0]

    def heads(x):
        x = trace_op("reshape2", {"X": [x]},
                     {"shape": [B, S, h, dh]})["Out"][0]
        return trace_op("transpose2", {"X": [x]},
                        {"axis": [0, 2, 1, 3]})["Out"][0]

    def forward(ids, bias, pos, labels):
        x = emb(ids)
        for i, lay in enumerate(lays):
            q, k, v = (heads(lay[n](x)) for n in ("q", "k", "v"))
            a = trace_op("fused_attention", {"Q": [q], "K": [k], "V": [v],
                                             "Bias": [bias]},
                         {"scale": dh ** -0.5, "dropout": p_drop})["Out"][0]
            a = trace_op("transpose2", {"X": [a]},
                         {"axis": [0, 2, 1, 3]})["Out"][0]
            a = trace_op("reshape2", {"X": [a]},
                         {"shape": [B, S, d]})["Out"][0]
            x = norm(x + drop(lay["o"](a)), norms[2 * i])
            f = trace_op("gelu", {"X": [lay["f1"](x)]}, {})["Out"][0]
            x = norm(x + lay["f2"](f), norms[2 * i + 1])
        flat = trace_op("reshape2", {"X": [x]},
                        {"shape": [B * S, d]})["Out"][0]
        picked = trace_op("gather", {"X": [flat], "Index": [pos]},
                          {})["Out"][0]
        loss = trace_op("softmax_with_cross_entropy",
                        {"Logits": [head(picked)], "Label": [labels]},
                        {})["Loss"][0]
        return trace_op("mean", {"X": [loss]}, {})["Out"][0]

    adam = iopt.Adam(learning_rate=1e-3)

    def params():
        return (emb.parameters() + [p for lay in lays for fc in lay.values()
                                    for p in fc.parameters()]
                + head.parameters() + ln.parameters())

    def step(ids, bias, pos, labels):
        loss = forward(ids, bias, pos, labels)
        loss.backward()
        adam.step(params())
        return loss

    return step, params


def _encoder_batches(n):
    rs = np.random.RandomState(5)
    B, S = ENC["batch"], ENC["seq"]
    out = []
    for _ in range(n):
        mask = np.ones((B, S), np.float32)
        mask[1, S - 5:] = 0.0
        out.append((
            rs.randint(0, ENC["vocab"], (B, S)).astype(np.int64),
            ((mask - 1.0) * 1e9)[:, None, None, :].astype(np.float32),
            (rs.randint(0, S, (B, ENC["mask"]))
             + S * np.arange(B)[:, None]).reshape(-1).astype(np.int64),
            rs.randint(0, ENC["vocab"], (B * ENC["mask"], 1))
            .astype(np.int64)))
    return out


def _encoder_run(captured, n=3):
    batches = _encoder_batches(n)
    with imperative.guard(place=CPU, seed=11):
        step, params = _encoder(11)
        fn = imperative.jit(step) if captured else step
        losses = [fn(*[_leaf(a) for a in b]).numpy() for b in batches]
        out = [p.numpy() for p in params()]
        chain = imperative.get_tracer()._rng.get_state().numpy()
    return losses, out, chain, fn


def test_encoder_capture_bitwise_eager(monkeypatch):
    """Flash attention (its operator, forced below S = 256), its dropout,
    layer norms, gelu, gather and the MLM loss: three captured steps are
    bitwise three eager ones."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "0")
    e_losses, e_params, e_chain, _ = _encoder_run(False)
    c_losses, c_params, c_chain, cap = _encoder_run(True)
    assert cap.stats["captures"] == 1 and cap.stats["hits"] == 2
    ops = {op.type for op in cap.program.global_block().ops}
    assert {"fused_attention", "fused_attention_grad", "layer_norm",
            "adam"} <= ops
    for a, b in zip(e_losses, c_losses):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(e_params, c_params):
        assert a.tobytes() == b.tobytes()
    assert e_chain.tobytes() == c_chain.tobytes()
    assert np.isfinite(e_losses).all()


def test_backward_frees_the_walked_tape():
    """The walk drops each entry once consumed: nothing of the forward is
    held after backward (the tape, the activations' gradients)."""
    import gc
    import weakref

    with imperative.guard(place=CPU):
        fc = inn.FC("fc", 8)
        x = _leaf(np.ones((4, 8), np.float32))
        h = trace_op("relu", {"X": [fc(x)]}, {})["Out"][0]
        probe = weakref.ref(h)
        loss = _loss(h)
        del h
        loss.backward()
        gc.collect()
        assert imperative.get_tracer().tape == []
        assert probe() is None
        assert fc._w.gradient() is not None
