"""The port's mesh-parallel tier (paddle_tpu_torch/parallel, compiler.py)
against the JAX package's on the CPU.

Both packages build one Program under the same names; the port starts
from the JAX package's post-startup scope (``convert.params_from_jax``)
and both run the same numpy feeds on the same mesh shapes: the JAX
package on its 8 forced CPU devices (tests/conftest.py), the port on 8
``CPUPlace()`` positions of one device. No program draws randomness.
Losses agree to a relative 1e-5 and params to atol 1e-4
(tests/test_torch_training.py's tolerances); the sequence-parallel
transformer is held as tests/test_torch_ring_attention.py holds the
packed GPT. Properties the JAX package pins
within itself (run_repeated against sequential runs, ZeRO-1 against
plain data parallelism) are pinned within the port.
"""

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.parallel import ParallelEngine as JaxEngine
from paddle_tpu.parallel import ShardingRules as JaxRules
from paddle_tpu.parallel.engine import make_mesh as jax_mesh
from paddle_tpu.parallel.sharding import P as JP
from paddle_tpu_torch.parallel import ParallelEngine, ShardingRules
from paddle_tpu_torch.parallel.engine import make_mesh
from paddle_tpu_torch.parallel.mesh import P

from torch_parity import jax_state, port_scope

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
CPU8 = [pt.CPUPlace()] * 8


@pytest.fixture(scope="module", autouse=True)
def _no_global_gradient_clip():
    """Another test file may leave either package's process-global
    gradient clip set; this module runs with neither."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.clip, "_global_clip", None)
        mp.setattr(pt.clip, "_global_clip", None)
        yield


def _mlp(pkg, opt="sgd"):
    x = pkg.layers.data("x", [32])
    y = pkg.layers.data("y", [1], dtype="int64")
    h = pkg.layers.fc(x, size=64, act="relu")
    probs = pkg.layers.fc(h, size=10, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(probs, y))
    if opt == "sgd":
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    else:
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return loss


def _batches(n, bs=16, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.rand(bs, 32).astype("float32"),
             "y": rs.randint(0, 10, size=(bs, 1)).astype("int64")}
            for _ in range(n)]


class _Pair:
    """One program built in both packages, the JAX startup run and its
    scope transplanted into the port's."""

    def __init__(self, build, seed=5):
        self.progs = {}
        for key, pkg in (("jax", jf), ("port", pt)):
            main, startup = pkg.Program(), pkg.Program()
            main.random_seed = startup.random_seed = seed
            with pkg.program_guard(main, startup), pkg.unique_name.guard():
                fetch = build(pkg)
            self.progs[key] = (main, startup, fetch)
        jmain, jstart, _ = self.progs["jax"]
        self.jexe, self.jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
        self.jexe.run(jstart, scope=self.jscope)
        self.state = jax_state(jmain, self.jscope)
        self.texe = pt.Executor(pt.CPUPlace())

    def port_scope(self):
        return port_scope(self.state, self.progs["port"][0])

    def params(self):
        return sorted(v.name for v in self.progs["port"][0].list_vars()
                      if v.persistable and v.name in self.state)


def _first(v):
    return float(np.asarray(v).reshape(-1)[0])


def _close(jl, tl, jscope, tscope, names, rtol=LOSS_RTOL,
           atol=PARAM_ATOL):
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    for n in names:
        np.testing.assert_allclose(
            tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
            atol=atol, err_msg=n)


def _engines(pair, jmesh=None, jrules=None, tmesh=None, trules=None):
    jmain, _, jl = pair.progs["jax"]
    tmain, _, tl = pair.progs["port"]
    je = JaxEngine(jmain, loss_name=jl.name, mesh=jmesh, rules=jrules)
    te = ParallelEngine(tmain, loss_name=tl.name,
                        mesh=tmesh or make_mesh(CPU8), rules=trules)
    return je, te, jl, tl


@pytest.mark.parametrize("case", ["dp", "tp"])
def test_engine_trains_like_the_jax_package(case):
    """Data parallel on (data 8), tensor-parallel fc weights on (data 2,
    model 4): the port's engine against the JAX engine, 4 SGD steps,
    and against the port's own single-device run (the same global
    math, so bitwise)."""
    pair = _Pair(_mlp)
    if case == "tp":
        jm = jax_mesh(jax.devices(), ("data", "model"), (2, 4))
        tm = make_mesh(CPU8, ("data", "model"), (2, 4))
        jr = JaxRules([(r"fc_.*\.w_0", JP(None, "model"))])
        tr = ShardingRules([(r"fc_.*\.w_0", P(None, "model"))])
    else:
        jm = tm = jr = tr = None
    je, te, jl, tl = _engines(pair, jm, jr, tm, tr)
    tscope, single = pair.port_scope(), pair.port_scope()
    tmain = pair.progs["port"][0]
    jls, tls, sls = [], [], []
    for feed in _batches(4):
        jls.append(_first(je.run(feed, [jl], pair.jscope)[0]))
        tls.append(_first(te.run(feed, [tl], tscope)[0]))
        sls.append(_first(pair.texe.run(tmain, feed=feed, fetch_list=[tl],
                                        scope=single)[0]))
    _close(jls, tls, pair.jscope, tscope, pair.params())
    assert tls == sls and tls[-1] < tls[0]
    plan = next(iter(te._cache.values()))
    assert plan.feed_specs == {"x": P("data"), "y": P("data")}
    if case == "tp":
        # fc_0.w_0 [32, 64] splits over model; fc_1.w_0 [64, 10] does not
        # divide and falls back to replicated, as spec_for does
        assert plan.state_specs["fc_0.w_0"] == P(None, "model")
        assert plan.state_specs["fc_1.w_0"] == P()
        view = te.shard("fc_0.w_0", {"data": 1, "model": 3}, tscope)
        w = tscope.find_var("fc_0.w_0")
        assert view.shape == (32, 16)
        assert view.data_ptr() == w[:, 48:].data_ptr()  # a view


def test_compiled_program_and_parallel_executor(monkeypatch):
    """``fluid.CompiledProgram(...).with_data_parallel`` through
    ``Executor.run`` and ``run_repeated`` (CPU_NUM=8 positions on
    ``CPUPlace()``), against the JAX package's on its 8 devices; and
    ``ParallelExecutor``'s per-position list feeds and their refusal."""
    monkeypatch.setenv("CPU_NUM", "8")
    pair = _Pair(_mlp)
    jmain, _, jl = pair.progs["jax"]
    tmain, _, tl = pair.progs["port"]
    jprog = jf.CompiledProgram(jmain).with_data_parallel(loss_name=jl.name)
    tprog = pt.CompiledProgram(tmain).with_data_parallel(loss_name=tl.name)
    tscope = pair.port_scope()
    batches = _batches(3, seed=1)
    jls = [_first(pair.jexe.run(jprog, feed=f, fetch_list=[jl],
                                scope=pair.jscope)[0]) for f in batches]
    tls = [_first(pair.texe.run(tprog, feed=f, fetch_list=[tl],
                                scope=tscope)[0]) for f in batches]
    (jr,) = pair.jexe.run_repeated(jprog, feed=batches[0], fetch_list=[jl],
                                   scope=pair.jscope, steps=2)
    (tr,) = pair.texe.run_repeated(tprog, feed=batches[0], fetch_list=[tl],
                                   scope=tscope, steps=2)
    _close(jls + [_first(jr)], tls + [_first(tr)], pair.jscope, tscope,
           pair.params())
    assert tprog._engine.device_count == 8
    assert tprog._engine.mesh.device == torch.device("cpu")

    pe = pt.ParallelExecutor(use_cuda=False, loss_name=tl.name,
                             main_program=tmain, scope=tscope)
    assert pe.device_count == 8
    feed = _batches(1, seed=2)[0]
    split = [{k: v[i * 2:(i + 1) * 2] for k, v in feed.items()}
             for i in range(8)]
    snap = {n: tscope.find_var(n).clone() for n in pair.params()}
    (l1,) = pe.run([tl.name], feed=feed)
    for n, t in snap.items():
        tscope.set_var(n, t.clone())
    (l2,) = pe.run([tl.name], feed=split)
    assert _first(l1) == _first(l2)
    with pytest.raises(ValueError, match="same size as places"):
        pe.run([tl.name], feed=split[:2])
    with pytest.raises(TypeError, match="should be a dict"):
        pe.run([tl.name], feed=[1] * 8)
    pe2 = pt.ParallelExecutor(use_cuda=False, loss_name=tl.name,
                              main_program=tmain, share_vars_from=pe)
    assert pe2._scope is tscope


def test_run_repeated_windows_and_reductions():
    """``run_repeated``: K steps on a constant feed equal K ``run``
    calls; a stacked window keeps each step's slice data-split (the
    plan's window spec P(None, 'data')) and matches the JAX engine's
    scanned window; ``reduce_fetches='mean'`` is the per-batch mean."""
    from paddle_tpu import reader as jrd
    from paddle_tpu_torch import reader as trd

    pair = _Pair(_mlp)
    tmain, _, tl = pair.progs["port"]
    feed = _batches(1)[0]
    seq, rep = pair.port_scope(), pair.port_scope()
    e1 = ParallelEngine(tmain, tl.name, mesh=make_mesh(CPU8))
    for _ in range(5):
        (l_seq,) = e1.run(feed, [tl], seq)
    e2 = ParallelEngine(tmain, tl.name, mesh=make_mesh(CPU8))
    (l_rep,) = e2.run_repeated(feed, [tl], rep, steps=5)
    assert _first(l_seq) == _first(l_rep)

    batches = _batches(4, seed=3)
    je, te, jl, tl = _engines(pair)
    tscope = pair.port_scope()
    (jw,) = je.run_repeated(jrd.stack_feed_window(batches), [jl],
                            pair.jscope, steps=4, feed_stacked=True)
    (tw,) = te.run_repeated(trd.stack_feed_window(batches), [tl], tscope,
                            steps=4, feed_stacked=True)
    _close([_first(jw)], [_first(tw)], pair.jscope, tscope, pair.params())
    plan = next(iter(te._cache.values()))
    assert plan.window_specs["x"] == P(None, "data")

    s1, s2 = pair.port_scope(), pair.port_scope()
    e3 = ParallelEngine(tmain, tl.name, mesh=make_mesh(CPU8))
    per = [_first(e3.run(b, [tl], s1)[0]) for b in batches[:3]]
    e4 = ParallelEngine(tmain, tl.name, mesh=make_mesh(CPU8))
    (m,) = e4.run_repeated(trd.stack_feed_window(batches[:3]), [tl], s2,
                           steps=3, feed_stacked=True,
                           reduce_fetches="mean")
    np.testing.assert_allclose(_first(m), np.mean(per), rtol=1e-6)


def test_check_nan_inf_and_collective_description_contracts():
    """FLAGS_check_nan_inf guards the mesh path (run and run_repeated);
    ``lowered_collectives`` refuses a stacked single step and a window
    whose leading axis disagrees with ``steps``, as the JAX engine's
    ``lowered_hlo`` does."""
    pair = _Pair(_mlp)
    tmain, _, tl = pair.progs["port"]
    te = ParallelEngine(tmain, tl.name, mesh=make_mesh(CPU8))
    tscope = pair.port_scope()
    feed = _batches(1)[0]
    bad = dict(feed, x=np.full_like(feed["x"], np.nan))
    old = pt.flags.get_flag("check_nan_inf")
    pt.flags.set_flag("check_nan_inf", True)
    try:
        with pytest.raises(FloatingPointError):
            te.run(bad, [tl], tscope)
        with pytest.raises(FloatingPointError, match="scanned"):
            te.run_repeated(bad, [tl], tscope, steps=3)
    finally:
        pt.flags.set_flag("check_nan_inf", old)
    with pytest.raises(ValueError, match="unstack"):
        te.lowered_collectives({k: v[None] for k, v in feed.items()}, [tl],
                               tscope, steps=1, feed_stacked=True)
    window = {k: np.stack([v] * 4) for k, v in feed.items()}
    with pytest.raises(ValueError, match="leading steps axis of 3"):
        te.lowered_collectives(window, [tl], tscope, steps=3,
                               feed_stacked=True)
    txt = te.lowered_collectives(feed, [tl], tscope)
    assert txt.splitlines() == ["mesh data=8, 8 positions, 1 step(s) a call"]


def test_zero1_shards_the_moments_and_matches_plain_dp():
    """ZeRO-1 (``ShardingRules(zero1=True)``): the recorded Adam moments
    take P('data') where the axis divides them, the beta powers stay
    replicated, and the training is bitwise plain data parallelism's."""
    pair = _Pair(lambda pkg: _mlp(pkg, "adam"))
    tmain, _, tl = pair.progs["port"]
    runs = {}
    for zero1 in (False, True):
        scope = pair.port_scope()
        e = ParallelEngine(tmain, tl.name, mesh=make_mesh(CPU8),
                           rules=ShardingRules(zero1=zero1))
        runs[zero1] = [_first(e.run(b, [tl], scope)[0])
                       for b in _batches(3)]
        if zero1:
            specs = next(iter(e._cache.values())).state_specs
            slots = sorted(tmain._optimizer_slots)
            moment = [s for s in slots if "moment1" in s and "fc_0.w_0" in s]
            beta = [s for s in slots if "beta1_pow" in s]
            assert moment and specs[moment[0]] == P("data")
            assert beta and specs[beta[0]] == P()
    assert runs[True] == runs[False]


def test_collectives_over_positions():
    """The collectives over a list of per-position values, as the lax
    ones act on an axis: psum and all_gather replicate, ppermute routes
    (a position that receives nothing holds None), all_to_all sends
    block j of each position to position j; a shard is a view."""
    from paddle_tpu_torch.parallel import mesh as pm

    xs = [torch.full((4, 2), float(i)) for i in range(4)]
    assert pm.axis_index(4) == [0, 1, 2, 3]
    assert all(torch.equal(t, torch.full((4, 2), 6.0))
               for t in pm.psum(xs))
    g = pm.all_gather(xs)
    assert all(t is g[0] for t in g) and g[0].shape == (4, 4, 2)
    moved = pm.ppermute(xs, [(0, 1), (1, 2), (2, 3)])
    assert moved[0] is None and moved[3] is xs[2]
    a2a = pm.all_to_all([torch.arange(4.0) + 10 * i for i in range(4)], 0,
                        0)
    assert [t.tolist() for t in a2a] == [[10 * i + j for i in range(4)]
                                         for j in range(4)]
    mesh = make_mesh(CPU8, ("data", "model"), (2, 4))
    w = torch.arange(64.0).reshape(8, 8)
    blk = pm.shard(w, P("data", ("model",)), mesh, {"data": 1, "model": 2})
    assert torch.equal(blk, w[4:, 4:6])
    assert blk.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        pm.shard(torch.zeros(3, 8), P("model"), mesh, (0, 0))


def test_mesh_refuses_two_devices_and_env_parses():
    with pytest.raises(NotImplementedError, match="A11, part 2"):
        make_mesh([pt.CPUPlace(), pt.CUDAPlace(0)])
    from paddle_tpu_torch.parallel import ParallelEnv, init_parallel_env

    env = ParallelEnv({"PADDLE_TRAINER_ID": "1",
                       "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2"})
    assert (env.rank, env.world_size, env.current_endpoint) == (1, 2, "b:2")
    assert init_parallel_env(ParallelEnv({})).world_size == 1


def test_sequence_parallel_transformer_rides_the_ring():
    """Under a (data 2, seq 4) mesh the transformer's encoder, causal
    decoder and cross attention ride the ring: 3 SGD steps against the
    JAX package's single-device run within test_parallel_engine.py's
    2e-4 / 2e-5 (tests/test_torch_ring_attention.py's check)."""
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu_torch.models import transformer as ttr
    from test_torch_ring_attention import check_ring_run

    cfg = dict(d_model=32, d_ff=64, n_head=2, n_layer=1, src_vocab=64,
               trg_vocab=64, max_length=16, dropout=0.0)

    def build(pkg):
        loss, _ = (jtr if pkg is jf else ttr).build(
            cfg, seq_len=16, use_fused_attention=True, label_smooth_eps=0.0)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss

    rs = np.random.RandomState(3)
    feed = {n: rs.randint(1, 64, (4, 16)).astype("int64")
            for n in ("src_ids", "trg_ids", "lbl_ids")}
    ring = check_ring_run(build, feed, r"^(src|trg|lbl)_ids$", 2e-4, 2e-5)
    assert {ln.split("schedule=")[1].split()[0] for ln in ring} == {
        "contiguous", "zigzag"}


def test_trainer_parallel_trains(monkeypatch):
    """``contrib.Trainer(parallel=True)`` trains through
    ``CompiledProgram`` (4 positions on ``CPUPlace()``), its losses those
    of ``parallel=False``."""
    monkeypatch.setenv("CPU_NUM", "4")
    rs = np.random.RandomState(0)
    data = [(rs.rand(32).astype("float32"), rs.randint(0, 10, (1,)))
            for _ in range(16)]

    def reader():
        for i in range(0, 16, 8):
            yield data[i:i + 8]

    losses = {}
    for parallel in (False, True):
        got = []

        def handler(ev):
            if isinstance(ev, pt.contrib.EndStepEvent):
                got.append(_first(ev.metrics[0]))

        with pt.unique_name.guard():
            t = pt.contrib.Trainer(
                lambda: [_mlp_loss()], lambda: pt.optimizer.SGD(0.1),
                place=pt.CPUPlace(), parallel=parallel)
        t.train(2, handler, reader, ["x", "y"])
        losses[parallel] = got
        if parallel:
            assert t._compiled._engine.device_count == 4
    assert len(losses[True]) == 4
    assert losses[True] == losses[False]


def _mlp_loss():
    x = pt.layers.data("x", [32])
    y = pt.layers.data("y", [1], dtype="int64")
    probs = pt.layers.fc(pt.layers.fc(x, 16, act="relu"), 10, act="softmax")
    return pt.layers.mean(pt.layers.cross_entropy(probs, y))
