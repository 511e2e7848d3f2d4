"""The port's step loop (core/pipeline.py, ``Executor.run_pipelined`` and
``train_loop``) on the CPU.

- Against the JAX package: the same numpy batches go through the JAX
  package's ``train_loop`` and the port's, the port's run starting from
  the JAX package's post-startup scope (``convert.params_from_jax``), at
  K = 1 and K = 4 steps per call with ``reduce_fetches`` last and mean,
  on the MLP of tests/test_device_pipeline.py and the 2-layer BERT of
  tests/test_torch_training.py (dropout off). Losses agree to a relative
  1e-5 and params to atol 1e-4, test_torch_training.py's tolerances.
- Against the port's own ``run`` loop: bitwise (losses, params, Adam
  slots and the RNG chain), dropout on.
- The JAX package's pipeline tests (test_device_pipeline.py), in the
  port's terms: eager validation, a reader's exception, an abandoned
  consumer, single use, the in-flight cap and backpressure with an empty
  fetch list, the completion probe, every const-dedup rule, the int64
  range check without a program, the readers' thread guards. None of
  them times anything.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import observe
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.executor import RNG_VAR, _completion_probe
from paddle_tpu_torch.core.pipeline import (ConstFeedCache, DevicePrefetcher,
                                            FetchHandle)
from paddle_tpu_torch.models import bert as tbert

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _no_global_gradient_clip():
    """tests/test_grad_accum.py sets the JAX package's process-global
    gradient clip (``clip.set_gradient_clip``) and leaves it set, so a
    later ``minimize`` in the same process appends clip ops to the JAX
    program alone. This module's fixtures and tests run with neither
    package's global clip set."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.clip, "_global_clip", None)
        mp.setattr(pt.clip, "_global_clip", None)
        yield


def _value(name, **labels):
    for s in observe.snapshot()["metrics"][name]["samples"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0.0


def _hist_count(name):
    return observe.snapshot()["metrics"][name]["samples"][0]["count"]


def _build(pkg=pt, seed=7, in_dim=8, hidden=16, depth=1, dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [in_dim], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        h = x
        for _ in range(depth):
            h = pkg.layers.fc(h, hidden, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _batches(n, batch=16, in_dim=8, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(batch, in_dim).astype("float32"),
             "y": rs.randn(batch, 1).astype("float32")} for _ in range(n)]


def _copy(v):
    if isinstance(v, torch.Generator):
        g = torch.Generator()
        g.set_state(v.get_state())
        return g
    return v.clone()


def _started(main, startup, seed_scope=None):
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    if seed_scope is None:
        exe.run(startup, scope=scope)
    else:
        for n, v in seed_scope.items():
            scope.set_var(n, _copy(v))
    return exe, scope


def _state(scope):
    """Every scope value (params, Adam slots, the RNG chain as its state
    bytes) by name."""
    out = {}
    for n in scope.local_var_names():
        v = scope.find_var(n)
        out[n] = (v.get_state() if isinstance(v, torch.Generator)
                  else v).numpy().tobytes()
    return out


def _weights(scope):
    names = sorted((n for n in scope.local_var_names()
                    if n.endswith(".w_0")), key=lambda n: (len(n), n))
    return [scope.find_var(n).numpy().copy() for n in names]


# ------------------------------------------------- against the JAX package
def _jax_started(build):
    main, startup, loss = build(jf)
    exe = jf.Executor(jf.CPUPlace())
    scope = jf.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: np.array(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    return main, loss, exe, scope, state


def _both_train_loops(build, batches, k, reduce):
    """(JAX (losses, params), port (losses, params)) of ``train_loop``
    over ``batches`` at ``k`` steps per call, the port from the JAX
    package's post-startup scope."""
    jmain, jloss, jexe, jscope, state = _jax_started(build)
    jl = []
    jexe.train_loop(jmain, iter(batches), fetch_list=[jloss], scope=jscope,
                    steps_per_call=k, reduce_fetches=reduce,
                    on_step=lambda i, v: jl.append(
                        float(np.asarray(v[0]).reshape(-1)[0])))
    tmain, _, tloss = build(pt)
    scope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        scope.set_var(n, v)
    tl = []
    pt.Executor(pt.CPUPlace()).train_loop(
        tmain, iter(batches), fetch_list=[tloss], scope=scope,
        steps_per_call=k, reduce_fetches=reduce,
        on_step=lambda i, v: tl.append(float(np.asarray(v[0]).reshape(-1)[0])))
    params = [p.name for p in tmain.global_block().all_parameters()]
    return ((jl, {n: np.asarray(jscope.find_var(n)) for n in params}),
            (tl, {n: scope.find_var(n).numpy() for n in params}))


def _assert_close(jax_out, port_out, n_handles):
    (jl, jp), (tl, tp) = jax_out, port_out
    assert len(jl) == len(tl) == n_handles
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for n, want in jp.items():
        np.testing.assert_allclose(tp[n], want, atol=1e-4, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("k,reduce", [(1, "last"), (4, "last"),
                                      (4, "mean")])
def test_mlp_train_loop_matches_jax(k, reduce):
    batches = _batches(8)
    jax_out, port_out = _both_train_loops(
        lambda pkg: _build(pkg, depth=2), batches, k, reduce)
    _assert_close(jax_out, port_out, 8 // k)


BERT_CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
                type_vocab=2, max_length=40, dropout=0.0)
S, M, B = 40, 6, 3


def _bert(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    bert = jbert if pkg is jf else tbert
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = bert.build(BERT_CFG, seq_len=S, max_mask=M)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _bert_feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.ones((B, S), "float32")
        pos = np.zeros((B, M), "int64")
        weight = np.zeros((B, M), "float32")
        for i in range(B):
            real = S - rs.randint(S // 10, 2 * S // 5 + 1)
            mask[i, real:] = 0.0
            picks = rs.choice(real, M - i, replace=False)
            pos[i, :M - i] = i * S + picks
            weight[i, :M - i] = 1.0
        out.append({
            "src_ids": rs.randint(0, BERT_CFG["vocab"], (B, S)).astype(
                "int64"),
            "sent_ids": rs.randint(0, 2, (B, S)).astype("int64"),
            "input_mask": mask, "mask_pos": pos,
            "mask_label": rs.randint(0, BERT_CFG["vocab"], (B, M)).astype(
                "int64"),
            "mask_weight": weight})
    return out


@pytest.mark.parametrize("k,reduce", [(1, "last"), (4, "mean")])
def test_bert_train_loop_matches_jax(k, reduce):
    jax_out, port_out = _both_train_loops(_bert, _bert_feeds(4), k, reduce)
    _assert_close(jax_out, port_out, 4 // k)


# ------------------------------------------- against the port's run loop
def _run_loop(batches, dropout=0.3):
    main, startup, loss = _build(dropout=dropout)
    exe, scope = _started(main, startup)
    losses = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
              for b in batches]
    return losses, _state(scope)


def _pipelined(batches, dropout=0.3, **kw):
    main, startup, loss = _build(dropout=dropout)
    exe, scope = _started(main, startup)
    seen = []
    n, last = exe.train_loop(main, iter(batches), fetch_list=[loss],
                             scope=scope,
                             on_step=lambda i, v: seen.append((i, v[0])),
                             **kw)
    return n, seen, last, _state(scope)


@pytest.mark.parametrize("k", [1, 4])
def test_train_loop_is_bitwise_the_run_loop(k):
    """7 batches: at K = 4 one window and a ragged tail of 3 steps."""
    batches = _batches(7)
    want, want_state = _run_loop(batches)
    n, seen, last, state = _pipelined(batches, steps_per_call=k)
    assert n == 7
    ends = list(range(7)) if k == 1 else [3, 4, 5, 6]
    assert [i for i, _ in seen] == ends
    for i, v in seen:
        assert v.tobytes() == want[i].tobytes()
    assert last[0].tobytes() == want[-1].tobytes()
    assert state == want_state
    assert RNG_VAR in state


def test_train_loop_shape_change_flushes_the_window_bitwise():
    batches = _batches(3, batch=16) + _batches(5, batch=8, seed=1)
    want, want_state = _run_loop(batches)
    r0 = _value("paddle_pipeline_window_ragged_steps_total")
    n, seen, _, state = _pipelined(batches, steps_per_call=4)
    assert n == 8
    # 3 flushed by the shape change, then a window of 4, then 1 ragged
    assert [i for i, _ in seen] == [0, 1, 2, 6, 7]
    assert _value("paddle_pipeline_window_ragged_steps_total") == r0 + 4
    for i, v in seen:
        assert v.tobytes() == want[i].tobytes()
    assert state == want_state


def test_run_pipelined_handles_and_return_numpy_false():
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    handles = list(exe.run_pipelined(main, iter(_batches(3)),
                                     fetch_list=[loss], scope=scope,
                                     return_numpy=False))
    assert [h.step for h in handles] == [0, 1, 2]
    for h in handles:
        assert isinstance(h, FetchHandle) and h.done()
        (val,) = h.result()
        assert isinstance(val, torch.Tensor) and val.device == CPU
        assert h.result()[0] is val  # idempotent


def test_train_loop_honours_a_var_replaced_in_on_step():
    """A var the callback replaces is read by the steps enqueued after
    it, as a run loop that sets it between two runs."""
    batches = _batches(6)
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    w = next(n for n in scope.local_var_names() if n.endswith(".w_0"))
    snap = {n: _copy(scope.find_var(n)) for n in scope.local_var_names()}

    def on_step(i, vals):
        if i == 1:
            scope.set_var(w, torch.zeros_like(scope.find_var(w)))

    exe.train_loop(main, iter(batches), fetch_list=[loss], scope=scope,
                   max_in_flight=1, on_step=on_step)
    got = _state(scope)
    # the run loop: with max_in_flight 1, step 1 resolves before step 3
    # is dispatched (step 2 is already in flight)
    exe2, scope2 = _started(main, startup, snap)
    for i, b in enumerate(batches):
        exe2.run(main, feed=b, fetch_list=[loss], scope=scope2)
        if i == 2:
            scope2.set_var(w, torch.zeros_like(scope2.find_var(w)))
    assert got == _state(scope2)


# -------------------------------------------------- validation and errors
def test_run_pipelined_validates_eagerly():
    main, startup, loss = _build()
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(ValueError):
        exe.run_pipelined(main, None, fetch_list=[loss])
    with pytest.raises(ValueError):
        exe.run_pipelined(main, iter([]), fetch_list=[loss],
                          max_in_flight=0)
    with pytest.raises(ValueError):
        DevicePrefetcher(iter([]), depth=0)
    with pytest.raises(ValueError):
        ConstFeedCache(capacity=0)
    cpu = pt.CPUPlace()
    with pytest.raises(ValueError, match="conflicts"):
        exe.run_pipelined(main, DevicePrefetcher(iter([]), place=cpu,
                                                 depth=2),
                          fetch_list=[loss], prefetch_depth=4)
    spent = DevicePrefetcher(iter([]), place=cpu)
    spent.close()
    with pytest.raises(RuntimeError, match="single-use"):
        exe.run_pipelined(main, spent, fetch_list=[loss])
    with pytest.raises(RuntimeError, match="single-use"):
        iter(spent)


def test_run_pipelined_rejects_a_prefetcher_for_another_device():
    main, startup, loss = _build()
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(ValueError, match="place=executor.place"):
        exe.run_pipelined(main, DevicePrefetcher(iter(_batches(1))),
                          fetch_list=[loss])


def test_prefetcher_reader_exception_propagates():
    def bad_reader():
        yield {"x": np.zeros((2, 2), "float32")}
        raise RuntimeError("reader died mid-epoch")

    pf = DevicePrefetcher(bad_reader(), place=pt.CPUPlace())
    it = iter(pf)
    next(it)
    with pytest.raises(RuntimeError, match="mid-epoch"):
        next(it)
    pf._thread.join(timeout=5)
    assert not pf.is_alive()


def test_prefetcher_abandoned_consumer_stops_thread():
    def infinite():
        i = 0
        while True:
            yield {"x": np.full((4, 4), i, "float32")}
            i += 1

    pf = DevicePrefetcher(infinite(), place=pt.CPUPlace(), depth=2)
    it = iter(pf)
    next(it)
    next(it)
    it.close()
    pf._thread.join(timeout=5)
    assert not pf.is_alive()


def test_prefetcher_is_single_use_and_close_unblocks_consumer():
    cpu = pt.CPUPlace()
    pf = DevicePrefetcher(iter([{"x": np.zeros((2, 2), "float32")}]),
                          place=cpu)
    assert len(list(pf)) == 1
    with pytest.raises(RuntimeError, match="single-use"):
        iter(pf).__next__()
    pf2 = DevicePrefetcher(iter([{"x": np.zeros((2, 2), "float32")}]),
                           place=cpu)
    pf2.close()
    with pytest.raises(RuntimeError, match="single-use"):
        iter(pf2).__next__()

    release = threading.Event()

    def stalled():
        yield {"x": np.zeros((2, 2), "float32")}
        release.wait(30)  # never produces again within the test
        yield {"x": np.zeros((2, 2), "float32")}

    pf3 = DevicePrefetcher(stalled(), place=cpu)
    it = iter(pf3)
    next(it)
    got = []
    t = threading.Thread(target=lambda: got.extend(it), daemon=True)
    t.start()
    time.sleep(0.2)  # the consumer now waits for the 2nd batch
    pf3.close()
    t.join(timeout=5)
    release.set()
    assert not t.is_alive()
    assert got == []


def test_run_pipelined_abandon_and_executor_close_in_flight():
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    pf = DevicePrefetcher(iter(_batches(8)), place=exe.place, program=main,
                          depth=2)
    gen = exe.run_pipelined(main, pf, fetch_list=[loss], scope=scope)
    h0 = next(gen)
    h1 = next(gen)
    exe.close()  # the plan cache dropped while h0 / h1 are unresolved
    gen.close()  # abandoned: drains the window, stops the prefetcher
    pf._thread.join(timeout=5)
    assert not pf.is_alive()
    assert np.isfinite(h0.result()[0]).all()
    assert np.isfinite(h1.result()[0]).all()


def test_train_loop_without_a_card_raises(monkeypatch):
    """The card is the default place; without one, nothing falls back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, startup, loss = _build()
    exe = pt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exe.train_loop(main, iter(_batches(2)), fetch_list=[loss])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exe.run_pipelined(main, iter(_batches(2)), fetch_list=[loss])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iter(DevicePrefetcher(iter(_batches(2))))


# ------------------------------------------------------- in-flight window
def test_in_flight_window_bounds_dispatch():
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    waits = []
    orig = FetchHandle.wait

    def wait(self):
        waits.append(self.step)
        return orig(self)

    FetchHandle.wait = wait
    try:
        prev = None
        for h in exe.run_pipelined(main, iter(_batches(6)),
                                   fetch_list=[loss], scope=scope,
                                   max_in_flight=1):
            if prev is not None:
                # before dispatching step N the window waited on N-1
                assert waits[-1] == prev.step
            prev = h
    finally:
        FetchHandle.wait = orig
    assert _value("paddle_pipeline_in_flight_steps") == 0


def test_empty_fetch_list_keeps_window_backpressure():
    batches = _batches(4)
    main, startup, _ = _build()
    exe, scope = _started(main, startup)
    for b in batches:
        exe.run(main, feed=b, fetch_list=[], scope=scope)
    ref = _weights(scope)
    main2, startup2, _ = _build()
    exe2, scope2 = _started(main2, startup2)
    handles = list(exe2.run_pipelined(main2, iter(batches), scope=scope2,
                                      max_in_flight=2))
    assert all(h.fetch_names == () for h in handles)
    assert all(h.result() == [] and h.done() for h in handles)
    for a, b in zip(ref, _weights(scope2)):
        assert np.array_equal(a, b)
    assert _value("paddle_pipeline_in_flight_steps") == 0


def test_completion_probe_never_hands_out_state():
    """A handle waits on an event recorded after its step (on the card)
    or on nothing (the CPU): never on a state tensor, which K6/K7 update
    in place at the next step."""
    assert _completion_probe(CPU) == ()
    main, startup, _ = _build()
    exe, scope = _started(main, startup)
    state = {id(scope.find_var(n)) for n in scope.local_var_names()}
    for h in exe.run_pipelined(main, iter(_batches(2)), scope=scope):
        assert not any(id(b) in state for b in h._block_on)
        assert h._fetches == []


def test_overlap_ratio_counts_drain_waits():
    batches = _batches(2)
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    before = _hist_count("paddle_pipeline_wait_seconds")
    list(exe.run_pipelined(main, iter(batches), fetch_list=[loss],
                           scope=scope, max_in_flight=4))
    assert _hist_count("paddle_pipeline_wait_seconds") - before == 2
    assert 0.0 <= _value("paddle_pipeline_overlap_ratio") < 1.0


def test_run_latency_records_dispatch_and_complete_phases():
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)

    def count(phase):
        return _value("paddle_executor_run_seconds", site="run_pipelined",
                      phase=phase)

    d0, c0 = count("dispatch"), count("complete")
    exe.train_loop(main, iter(_batches(3)), fetch_list=[loss], scope=scope)
    assert count("dispatch") == d0 + 3
    assert count("complete") == c0 + 3


# ------------------------------------------------------- const-feed dedup
def test_const_feed_dedup_by_identity_and_invalidation_rule():
    const = np.full((16, 4), 3.0, "float32")

    def reader():
        for i in range(4):
            yield {"fresh": np.full((16, 4), float(i), "float32"),
                   "const": const}

    pf = DevicePrefetcher(reader(), place=pt.CPUPlace(), depth=1)
    b0 = _value("paddle_pipeline_h2d_bytes_total")
    h0 = _value("paddle_pipeline_const_feed_hits_total")
    got = list(pf)
    assert len(got) == 4
    # an unmarked array enters the cache at its SECOND sighting
    assert _value("paddle_pipeline_const_feed_hits_total") == h0 + 2
    assert _value("paddle_pipeline_h2d_bytes_total") - b0 == \
        6 * const.nbytes
    for i, feed in enumerate(got):
        assert float(feed["fresh"][0, 0]) == float(i)
        assert float(feed["const"][0, 0]) == 3.0
    cache = pf.const_cache
    const[:] = 7.0
    assert cache.lookup("const", const) is not None  # un-invalidated hit
    cache.invalidate(const)
    assert cache.lookup("const", const) is None
    cache.store("const", const, torch.from_numpy(const.copy()))
    assert float(cache.lookup("const", const)[0, 0]) == 7.0


def test_const_dedup_off_for_reuse_a_buffer_readers():
    buf = np.zeros((16, 4), "float32")

    def reader():
        for i in range(5):
            buf[:] = float(i)
            yield {"x": buf}

    cpu = pt.CPUPlace()
    h0 = _value("paddle_pipeline_const_feed_hits_total")
    got = list(DevicePrefetcher(reader(), place=cpu, depth=1,
                                const_dedup=False))
    assert [float(f["x"][0, 0]) for f in got] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert _value("paddle_pipeline_const_feed_hits_total") == h0
    got = list(DevicePrefetcher(reader(), place=cpu, depth=1,
                                const_dedup=False, const_feed_names=("x",)))
    assert all(float(f["x"][0, 0]) == 0.0 for f in got)
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    spent = DevicePrefetcher(iter(_batches(1)), place=cpu, const_dedup=True)
    with pytest.raises(ValueError, match="const_dedup"):
        exe.run_pipelined(main, spent, fetch_list=[loss], scope=scope,
                          const_dedup=False)


def test_const_feed_same_array_under_two_names_never_cross_served():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        pt.layers.data("x", [4], dtype="float32")
        pt.layers.data("y", [4], dtype="int64")
    shared = np.arange(8, dtype="int64").reshape(2, 4)

    def reader():
        for _ in range(4):
            yield {"x": shared, "y": shared}

    got = list(DevicePrefetcher(reader(), place=pt.CPUPlace(), program=main,
                                depth=1))
    assert len(got) == 4
    for feed in got:
        assert feed["x"].dtype == torch.float32
        assert feed["y"].dtype == torch.int32
        assert feed["x"] is not feed["y"]
        np.testing.assert_array_equal(feed["x"].numpy(),
                                      shared.astype("float32"))
        np.testing.assert_array_equal(feed["y"].numpy(), shared)


def test_const_cache_device_mismatch_is_a_miss():
    cache = ConstFeedCache()
    cache.mark_constant("w")
    arr = np.zeros(1, "float32")
    cache.store("w", arr, torch.zeros(1))
    assert cache.lookup("w", arr, device=CPU) is not None
    assert cache.lookup("w", arr, device=torch.device("cuda", 0)) is None
    assert cache.lookup("w", arr) is not None  # no device: no guard
    assert cache.lookup("w", arr, shape=(2,)) is None  # shape guard


def test_prefetcher_without_program_still_range_checks_int64():
    big = np.array([[2 ** 40]], dtype="int64")
    pf = DevicePrefetcher(iter([{"ids": big}]), place=pt.CPUPlace())
    with pytest.raises(OverflowError, match="int32 range"):
        list(pf)
    ok = np.array([[7]], dtype="int64")
    (feed,) = list(DevicePrefetcher(iter([{"ids": ok}]),
                                    place=pt.CPUPlace()))
    assert feed["ids"].dtype == torch.int32 and int(feed["ids"][0, 0]) == 7


def test_const_feed_marked_by_name_ignores_new_objects():
    cache = ConstFeedCache()
    cache.mark_constant("w")
    v1 = np.ones((4,), "float32")
    assert cache.lookup("w", v1) is None
    dev = torch.from_numpy(v1.copy())
    cache.store("w", v1, dev)
    v2 = np.ones((4,), "float32") * 9
    assert cache.lookup("w", v2) is dev
    cache.invalidate(name="w")
    assert cache.lookup("w", v2) is None


def test_const_cache_lru_eviction_never_serves_stale():
    cache = ConstFeedCache(capacity=2)
    arrs = [np.full((2,), i, "float32") for i in range(4)]
    for a in arrs:
        cache.store("x", a, torch.from_numpy(a.copy()))
    assert cache.lookup("x", arrs[0]) is None
    assert cache.lookup("x", arrs[3]) is not None


def test_feed_observers_see_each_step():
    from paddle_tpu_torch.core.executor import (add_feed_observer,
                                                remove_feed_observer)

    seen = []
    main, startup, loss = _build()
    exe, scope = _started(main, startup)
    add_feed_observer(seen.append)
    try:
        exe.train_loop(main, iter(_batches(3)), fetch_list=[loss],
                       scope=scope)
        exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    finally:
        remove_feed_observer(seen.append)
    remove_feed_observer(seen.append)  # unregistered: a no-op
    assert len(seen) == 4 and all(set(f) == {"x", "y"} for f in seen)


# ----------------------------------------------------------------- readers
def test_buffered_reader_abandoned_consumer_stops_producer():
    from paddle_tpu_torch import reader as rd

    before = threading.active_count()

    def infinite():
        i = 0
        while True:
            yield i
            i += 1

    gen = rd.buffered(infinite, 2)()
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_multiprocess_reader_worker_error_propagates():
    from paddle_tpu_torch import reader as rd

    def ok():
        yield from range(3)

    def bad():
        yield 1
        raise ValueError("worker died")

    with pytest.raises(ValueError, match="worker died"):
        list(rd.multiprocess_reader([ok, bad], queue_size=4)())


def test_readers_batch_shuffle_compose_and_stack():
    from paddle_tpu_torch import reader as rd

    r = lambda: iter(range(7))  # noqa: E731
    assert list(rd.batch(r, 3)()) == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(rd.batch(r, 3, drop_last=True)()) == [[0, 1, 2], [3, 4, 5]]
    assert sorted(rd.shuffle(r, 4)()) == list(range(7))
    assert list(rd.compose(r, r)()) == [(i, i) for i in range(7)]
    assert list(rd.firstn(r, 2)()) == [0, 1]
    host = rd.stack_feed_window([{"x": np.ones(2)}, {"x": np.zeros(2)}])
    assert isinstance(host["x"], np.ndarray) and host["x"].shape == (2, 2)
    dev = rd.stack_feed_window([{"x": torch.ones(2)}, {"x": torch.zeros(2)}])
    assert isinstance(dev["x"], torch.Tensor) and dev["x"].shape == (2, 2)
    with pytest.raises(ValueError, match="keys"):
        rd.stack_feed_window([{"x": 1}, {"y": 1}])
