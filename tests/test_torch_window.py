"""Windows of K steps per call in the port's step loop, and the window
tuner (core/window_tune.py), on the CPU: the port's counterparts of the
JAX package's tests/test_window_training.py (the supervisor's tests wait
for the port of resilience/).

- A windowed ``train_loop`` is BITWISE the per-step loop (params, Adam
  slots and the RNG chain, dropout on); a ragged window and a shape
  change run per step; a window's fetches follow ``reduce_fetches``.
- A window crosses to the device as one copy per feed
  (``paddle_pipeline_h2d_seconds`` observes one hand-off per window).
- ``resolve_steps_per_call``: argument > ``PADDLE_TPU_STEPS_PER_CALL`` >
  tuned winner > 1, a malformed env raising at the call.
- The tuner: a deterministic pick (``PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC``)
  that persists, is served from disk and moves the table's epoch; the
  state restored bitwise after a real measurement; bypassed with the
  kernel tier off. No test times anything.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import observe
from paddle_tpu_torch.core import window_tune as wt
from paddle_tpu_torch.core.executor import RNG_VAR
from paddle_tpu_torch.kernels import tune


def _value(name, **labels):
    for s in observe.snapshot()["metrics"][name]["samples"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0.0


def _count(name):
    return observe.snapshot()["metrics"][name]["samples"][0]["count"]


def _build(seed=7, dropout=True, hidden=16):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", [8], dtype="float32")
        y = pt.layers.data("y", [1], dtype="float32")
        h = pt.layers.fc(x, hidden, act="relu")
        if dropout:
            h = pt.layers.dropout(h, dropout_prob=0.3)
        pred = pt.layers.fc(h, 1)
        loss = pt.layers.mean(pt.layers.square(pred - y))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _batches(n, seed=0, batch=16):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(batch, 8).astype("float32"),
             "y": rs.randn(batch, 1).astype("float32")} for _ in range(n)]


def _state(scope):
    out = {}
    for n in scope.local_var_names():
        v = scope.find_var(n)
        out[n] = (v.get_state() if isinstance(v, torch.Generator)
                  else v).numpy().tobytes()
    return out


def _started():
    main, startup, loss = _build()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


def _run_loop(batches, steps_per_call, on_step=None, **kw):
    main, loss, exe, scope = _started()
    n, last = exe.train_loop(main, iter(batches), fetch_list=[loss],
                             scope=scope, steps_per_call=steps_per_call,
                             on_step=on_step, **kw)
    return n, last, _state(scope)


# ------------------------------------------------------------ parity
def test_windowed_train_loop_bitwise_parity_k4_vs_k1():
    batches = _batches(8)
    seen1, seen4 = [], []
    n1, last1, s1 = _run_loop(batches, 1, on_step=lambda i, v: seen1.append(
        (i, v[0].tobytes())))
    n4, last4, s4 = _run_loop(batches, 4, on_step=lambda i, v: seen4.append(
        (i, v[0].tobytes())))
    assert n1 == n4 == 8
    assert s1 == s4 and RNG_VAR in s1
    assert [i for i, _ in seen4] == [3, 7]
    per_step = dict(seen1)
    for i, v in seen4:
        assert v == per_step[i]
    assert np.array_equal(last1[0], last4[0])


def test_windowed_ragged_final_window_runs_per_step():
    r0 = _value("paddle_pipeline_window_ragged_steps_total")
    w0 = _count("paddle_pipeline_window_steps_per_dispatch")
    batches = _batches(7)
    n1, _, s1 = _run_loop(batches, 1)
    n4, _, s4 = _run_loop(batches, 4)
    assert n1 == n4 == 7
    assert s1 == s4
    assert _value("paddle_pipeline_window_ragged_steps_total") == r0 + 3
    assert _count("paddle_pipeline_window_steps_per_dispatch") == w0 + 1
    assert _value("paddle_pipeline_window_size") == 4


def test_windowed_shape_change_flushes_window_per_step():
    batches = _batches(3, batch=16) + _batches(3, batch=8, seed=1)
    r0 = _value("paddle_pipeline_window_ragged_steps_total")
    n, _, _ = _run_loop(batches, 4)
    assert n == 6
    assert _value("paddle_pipeline_window_ragged_steps_total") == r0 + 6


@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_windowed_reduce_fetches(reduce):
    batches = _batches(4)
    seen1, seen4 = [], []
    _run_loop(batches, 1, on_step=lambda i, v: seen1.append(float(v[0])))
    _run_loop(batches, 4, reduce_fetches=reduce,
              on_step=lambda i, v: seen4.append(float(v[0])))
    assert len(seen4) == 1
    want = np.mean(seen1) if reduce == "mean" else np.sum(seen1)
    np.testing.assert_allclose(seen4[0], want, rtol=1e-5)


def test_run_pipelined_validates_window_args():
    main, loss, exe, scope = _started()
    with pytest.raises(ValueError, match="steps_per_call"):
        exe.run_pipelined(main, iter(_batches(2)), [loss], scope,
                          steps_per_call=0)
    with pytest.raises(ValueError, match="last|mean|sum"):
        exe.run_pipelined(main, iter(_batches(2)), [loss], scope,
                          reduce_fetches="avg")


def test_windowed_prefetcher_stacks_one_h2d_per_window():
    batches = _batches(8)

    def h2d():
        return (_count("paddle_pipeline_h2d_seconds"),
                _value("paddle_pipeline_h2d_bytes_total"))

    c0, b0 = h2d()
    _, _, s1 = _run_loop(batches, 1)
    c1, b1 = h2d()
    assert c1 - c0 == 8
    _, _, s4 = _run_loop(batches, 4)
    c2, b2 = h2d()
    assert c2 - c1 == 2
    assert b2 - b1 == b1 - b0
    assert s1 == s4


def test_caller_supplied_prefetcher_windows_loop_side():
    batches = _batches(8)
    _, _, s1 = _run_loop(batches, 1)
    w0 = _count("paddle_pipeline_window_steps_per_dispatch")
    main, loss, exe, scope = _started()
    pre = pt.DevicePrefetcher(iter(batches), place=exe.place, program=main)
    assert pre.resolved_window is None
    n4, _ = exe.train_loop(main, pre, fetch_list=[loss], scope=scope,
                           steps_per_call=4)
    assert n4 == 8
    assert _state(scope) == s1
    assert _count("paddle_pipeline_window_steps_per_dispatch") == w0 + 2


def test_windowed_const_feed_ragged_tail_stays_bitwise():
    batches = _batches(6)
    for b in batches:
        b["y"] = batches[0]["y"]

    def run(spc):
        main, loss, exe, scope = _started()
        n, _ = exe.train_loop(main, iter(batches), fetch_list=[loss],
                              scope=scope, steps_per_call=spc,
                              const_feed_names=("y",))
        return n, _state(scope)

    n1, s1 = run(1)
    n4, s4 = run(4)
    assert n1 == n4 == 6
    assert s1 == s4


def test_windowed_const_feed_transfers_once():
    batches = _batches(8)
    for b in batches:
        b["y"] = batches[0]["y"]
    h0 = _value("paddle_pipeline_const_feed_hits_total")
    main, loss, exe, scope = _started()
    n, _ = exe.train_loop(main, iter(batches), fetch_list=[loss],
                          scope=scope, steps_per_call=4,
                          const_feed_names=("y",))
    assert n == 8
    assert _value("paddle_pipeline_const_feed_hits_total") == h0 + 1


def test_window_signature_host_and_device_feeds_agree():
    main, _, _ = _build()
    host = {"ids": np.arange(6, dtype="int64"),
            "x": np.zeros((2, 3), dtype="float64")}
    dev = {"ids": torch.arange(6, dtype=torch.int32),
           "x": torch.zeros((2, 3), dtype=torch.float32)}
    assert wt.window_signature(main, host) == wt.window_signature(main, dev)


# -------------------------------------------------------- resolution
def test_resolve_steps_per_call_precedence(monkeypatch):
    main, _, _ = _build()
    feed = _batches(1)[0]
    monkeypatch.delenv("PADDLE_TPU_STEPS_PER_CALL", raising=False)
    assert wt.resolve_steps_per_call(main, feed) == (1, "default")
    monkeypatch.setenv("PADDLE_TPU_STEPS_PER_CALL", "25")
    assert wt.resolve_steps_per_call(main, feed, 4) == (4, "arg")
    assert wt.resolve_steps_per_call(main, feed) == (25, "env")
    monkeypatch.setenv("PADDLE_TPU_STEPS_PER_CALL", "bogus")
    with pytest.raises(ValueError, match="STEPS_PER_CALL"):
        wt.resolve_steps_per_call(main, feed)
    monkeypatch.setenv("PADDLE_TPU_STEPS_PER_CALL", "0")
    with pytest.raises(ValueError, match="STEPS_PER_CALL.*>= 1"):
        wt.resolve_steps_per_call(main, feed)
    monkeypatch.delenv("PADDLE_TPU_STEPS_PER_CALL")
    tune.set_entry(wt.WINDOW_OP, wt.window_signature(main, feed),
                   {"choice": "cuda", "cfg": [10], "seconds": 1e-4})
    try:
        assert wt.resolve_steps_per_call(main, feed) == (10, "tuned")
    finally:
        tune.reset()
    with pytest.raises(ValueError, match="steps_per_call"):
        wt.resolve_steps_per_call(main, feed, 0)


def test_malformed_env_steps_per_call_raises_at_call_time(monkeypatch):
    main, loss, exe, scope = _started()
    monkeypatch.setenv("PADDLE_TPU_STEPS_PER_CALL", "nope")
    with pytest.raises(ValueError, match="STEPS_PER_CALL"):
        exe.run_pipelined(main, iter(_batches(2)), [loss], scope)
    # an explicit argument outvotes the env: no env parse at all
    gen = exe.run_pipelined(main, iter(_batches(2)), [loss], scope,
                            steps_per_call=1)
    assert len(list(gen)) == 2


def test_window_candidates_env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_WINDOW_CANDIDATES", raising=False)
    assert wt.window_candidates() == [1, 4, 10, 25, 50]
    monkeypatch.setenv("PADDLE_TPU_WINDOW_CANDIDATES", "8,2")
    assert wt.window_candidates() == [1, 2, 8]
    monkeypatch.setenv("PADDLE_TPU_WINDOW_CANDIDATES", "a,b")
    with pytest.raises(ValueError, match="WINDOW_CANDIDATES"):
        wt.window_candidates()


# -------------------------------------------------------------- tuner
@pytest.fixture
def tuner_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("PADDLE_TPU_STEPS_PER_CALL", raising=False)
    tune.reset()
    yield tmp_path
    tune.reset()


def test_window_tuner_deterministic_selects_persists_and_rekeys(
        tuner_cache, monkeypatch):
    """The pick is a pure function of the seed; it persists in the port's
    grammar (K > 1: ``cuda`` with cfg [K]; K = 1: ``composed``), a fresh
    table serves it from disk, installing it moves the table's epoch (a
    captured graph is captured anew), and the next train_loop with no
    explicit K runs windowed."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", "7")
    main, loss, exe, scope = _started()
    feed = _batches(1)[0]
    epoch0 = tune.epoch()
    dec = wt.tune_train_window(exe, main, feed, fetch_list=[loss],
                               scope=scope)
    assert dec["choice"] in ("cuda", "composed")
    assert "composed" in [t["label"] for t in dec["timings"]]
    assert tune.epoch() != epoch0
    data = json.load(open(tuner_cache / "tuned_kernels.json"))
    (key,) = data["entries"].keys()
    assert key.startswith("train_window|")
    tune.reset()
    k = wt.tuned_window(main, feed)
    assert k is not None
    assert (k > 1) == (dec["choice"] == "cuda")
    d0 = _value("paddle_kernel_dispatches_total", op="train_window",
                impl="cuda" if k > 1 else "composed")
    n, _ = exe.train_loop(main, iter(_batches(max(k, 2))),
                          fetch_list=[loss], scope=scope)
    assert n == max(k, 2)
    assert _value("paddle_pipeline_window_size") == k
    assert _value("paddle_kernel_dispatches_total", op="train_window",
                  impl="cuda" if k > 1 else "composed") == d0 + 1


def test_window_tuner_deterministic_is_stable(tuner_cache, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", "3")
    main, loss, exe, scope = _started()
    feed = _batches(1)[0]
    d1 = wt.tune_train_window(exe, main, feed, [loss], scope)
    tune.reset()
    d2 = wt.tune_train_window(exe, main, feed, [loss], scope)
    assert (d1["choice"], d1["cfg"]) == (d2["choice"], d2["cfg"])


def test_window_tuner_real_measurement_restores_state_bitwise(
        tuner_cache, monkeypatch):
    """A real tune runs training steps; the scope's params, Adam slots
    and RNG chain come back bitwise, and training resumes as it would
    have without the tune."""
    monkeypatch.delenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC",
                       raising=False)
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_REPEATS", "1")
    monkeypatch.setenv("PADDLE_TPU_WINDOW_CANDIDATES", "1,4")
    main, loss, exe, scope = _started()
    feed = _batches(1)[0]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    before = _state(scope)
    dec = wt.tune_train_window(exe, main, feed, [loss], scope)
    assert _state(scope) == before
    after_tune = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    main2, loss2, exe2, scope2 = _started()
    exe2.run(main2, feed=feed, fetch_list=[loss2], scope=scope2)
    want = exe2.run(main2, feed=feed, fetch_list=[loss2], scope=scope2)
    assert after_tune[0].tobytes() == want[0].tobytes()
    assert all(t["seconds"] > 0 for t in dec["timings"])


def test_window_tuner_memory_prunes_over_budget_windows(
        tuner_cache, monkeypatch):
    """With a device budget below the K = 4 window's predicted peak, each
    K > 1 is pruned without a measurement; K = 1 never is."""
    from paddle_tpu_torch.analysis.memory import MemoryAnalysis

    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", "5")
    monkeypatch.setenv("PADDLE_TPU_WINDOW_CANDIDATES", "1,4,10")
    main, loss, exe, scope = _started()
    ma = MemoryAnalysis(main, fetch_names=[loss.name], scope=scope)
    peak1, peak4 = (ma.peak_bytes(16, steps_per_call=k) for k in (1, 4))
    assert peak1 < peak4
    monkeypatch.setenv("PADDLE_TPU_DEVICE_HBM_BYTES", str(peak4 - 1))
    p0 = _value("paddle_analysis_memory_pruned_total")
    dec = wt.tune_train_window(exe, main, _batches(1)[0], [loss], scope)
    pruned = {t["label"]: t.get("pruned", False) for t in dec["timings"]}
    assert pruned == {"composed": False, "window:4": True,
                      "window:10": True}
    assert dec["choice"] == "composed"
    assert _value("paddle_analysis_memory_pruned_total") == p0 + 2


def test_window_tuner_bypassed_with_kernels_off(tuner_cache, monkeypatch):
    main, loss, exe, scope = _started()
    feed = _batches(1)[0]
    tune.set_entry(wt.WINDOW_OP, wt.window_signature(main, feed),
                   {"choice": "cuda", "cfg": [4], "seconds": 1e-4})
    monkeypatch.setenv("PADDLE_TPU_KERNELS", "0")
    assert wt.tuned_window(main, feed) is None
    names = ["paddle_kernel_tuner_hits_total",
             "paddle_kernel_tuner_misses_total",
             "paddle_kernel_dispatches_total"]
    snap0 = {n: json.dumps(observe.snapshot()["metrics"][n]["samples"],
                           sort_keys=True) for n in names}
    n, _ = exe.train_loop(main, iter(_batches(4)), fetch_list=[loss],
                          scope=scope)
    assert n == 4
    assert _value("paddle_pipeline_window_size") == 1
    for n_ in names:
        assert json.dumps(observe.snapshot()["metrics"][n_]["samples"],
                          sort_keys=True) == snap0[n_], n_


def test_peek_moves_no_counters():
    h0 = (_value("paddle_kernel_tuner_hits_total", tier="memory"),
          _value("paddle_kernel_tuner_misses_total"))
    assert tune.peek("train_window", ("nope",)) is None
    tune.set_entry("train_window", ("yep",),
                   {"choice": "cuda", "cfg": [4], "seconds": 1e-4})
    try:
        assert tune.peek("train_window", ("yep",))["cfg"] == [4]
        assert (_value("paddle_kernel_tuner_hits_total", tier="memory"),
                _value("paddle_kernel_tuner_misses_total")) == h0
    finally:
        tune.reset()
