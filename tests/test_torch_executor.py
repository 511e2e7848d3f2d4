"""The port's compiled-step executor layer on the CPU: ``run_repeated``,
``FLAGS_check_nan_inf`` and the CUDA-graph bookkeeping that needs no
card, held against the JAX package where it has a counterpart.

- ``run_repeated`` against the JAX package's (a jitted ``lax.scan``,
  as tests/test_run_repeated.py runs it) on an MLP (its dropout in test
  mode) and a 2-layer BERT MLM (dropout 0.0), the port's scope
  transplanted from the JAX package's post-startup scope
  (``convert.params_from_jax``): K = 3, ``feed_stacked`` both ways,
  ``reduce_fetches`` last, mean and sum, Adam and (BERT) SGD. The
  fetched loss agrees to a relative 1e-5 and params to atol 1e-5: a
  scan against an eager loop differ by f32 rounding only. The one
  exception, the BERT's key projections after Adam, agree to atol 1e-4
  (1.14e-5 measured): their grads are zero up to rounding (softmax
  ignores a per-row shift of the scores), and Adam moves such a param
  by about lr times the sign of the rounding noise, as
  tests/test_torch_training.py states for its 5 steps.
- Within the port, with dropout 0.1: ``run_repeated(3)`` is bitwise 3
  ``run`` calls (losses, params, the RNG chain), for each
  ``feed_stacked`` and ``reduce_fetches``.
- The reference's error messages, word for word: a stacked feed without
  the K axis, an unknown ``reduce_fetches``, ``steps=1`` with a window
  longer than 1.
- ``FLAGS_check_nan_inf``: off by default; on from ``FLAGS_check_nan_inf=1``
  at import or from ``set_flag``; a NaN fetch raises the reference's
  ``FloatingPointError`` (``run`` and ``run_repeated``), the same
  message in both packages on the same Program.
- The graph bookkeeping: ``state_changes`` (which replaced vars are
  copied into the captured tensors and which force a new capture), the
  fused optimizer's in-place decision, the eager step's ``StepTrace``
  (random ops' slots and constants in program order, without changing
  the step's result), and the LRU cache releasing an evicted plan's
  graph.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core.cuda_graph import (CHAIN, StepTrace,
                                              state_changes)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.fused_ops import _donated

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
K = 3
CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
           type_vocab=2, max_length=40, dropout=0.0)
S, M, B = 40, 6, 3
CASES = [(False, "last"), (True, "last"), (True, "mean"), (False, "sum"),
         (True, "sum"), (False, "mean")]


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


# ------------------------------------------------------------ models
def _mlp(pkg, opt="Adam", dropout=0.5, is_test=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        h = pkg.layers.fc(x, 16, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout, is_test=is_test)
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        getattr(pkg.optimizer, opt)(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _mlp_feeds(n):
    rs = np.random.RandomState(3)
    return [{"x": rs.randn(16, 8).astype("float32"),
             "y": rs.randn(16, 1).astype("float32")} for _ in range(n)]


def _bert(pkg, mod, opt="Adam", cfg=CFG):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = mod.build(cfg, seq_len=S, max_mask=M)
        getattr(pkg.optimizer, opt)(learning_rate=1e-3).minimize(loss)
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
            "src_ids": rs.randint(0, CFG["vocab"], (B, S)).astype("int64"),
            "sent_ids": rs.randint(0, 2, (B, S)).astype("int64"),
            "input_mask": mask, "mask_pos": pos,
            "mask_label": rs.randint(0, CFG["vocab"], (B, M)).astype(
                "int64"),
            "mask_weight": weight})
    return out


MODELS = {
    "mlp_adam": (lambda pkg, mod: _mlp(pkg, "Adam"), _mlp_feeds),
    "bert_sgd": (lambda pkg, mod: _bert(pkg, mod, "SGD"), _bert_feeds),
    "bert_adam": (lambda pkg, mod: _bert(pkg, mod, "Adam"), _bert_feeds),
}


def _window(feeds, stacked):
    return ({k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
            if stacked else feeds[0])


@pytest.fixture(scope="module")
def jax_repeated():
    """Per model: the JAX package's post-startup scope as numpy, and per
    (feed_stacked, reduce_fetches) its run_repeated(K) loss and params."""
    out = {}
    for name, (build, feeds_of) in MODELS.items():
        main, startup, loss = build(jf, jbert)
        exe = jf.Executor(jf.CPUPlace())
        scope = JScope()
        exe.run(startup, scope=scope)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
        params = [p.name for p in main.global_block().all_parameters()]
        feeds = feeds_of(K)
        runs = {}
        for stacked, reduce in CASES:
            sc = JScope()
            for n, v in state.items():
                sc.set_var(n, jnp.asarray(v))
            (val,) = exe.run_repeated(main, feed=_window(feeds, stacked),
                                      fetch_list=[loss], scope=sc, steps=K,
                                      feed_stacked=stacked,
                                      reduce_fetches=reduce)
            runs[(stacked, reduce)] = (
                np.asarray(val), {n: np.asarray(sc.find_var(n))
                                  for n in params})
        out[name] = dict(state=state, runs=runs)
    return out


@pytest.mark.parametrize("stacked,reduce", CASES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_run_repeated_matches_the_jax_package(jax_repeated, model, stacked,
                                              reduce):
    build, feeds_of = MODELS[model]
    main, _, loss = build(pt, tbert)
    ref = jax_repeated[model]
    scope = pt.Scope()
    for n, v in params_from_jax(ref["state"], main, CPU).items():
        scope.set_var(n, v)
    exe = pt.Executor(pt.CPUPlace())
    (val,) = exe.run_repeated(main, feed=_window(feeds_of(K), stacked),
                              fetch_list=[loss], scope=scope, steps=K,
                              feed_stacked=stacked, reduce_fetches=reduce)
    want_loss, want_params = ref["runs"][(stacked, reduce)]
    np.testing.assert_allclose(val, want_loss, rtol=1e-5, atol=0)
    for n, want in want_params.items():
        atol = 1e-4 if model == "bert_adam" and "_att_k." in n else 1e-5
        np.testing.assert_allclose(scope.find_var(n).numpy(), want,
                                   atol=atol, rtol=0, err_msg=n)


# ------------------------------------------------ the port against itself
def _copy_scope(scope):
    sc = pt.Scope()
    for n in scope.local_var_names():
        v = scope.find_var(n)
        sc.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return sc


@pytest.mark.parametrize("stacked,reduce", CASES[:4])
@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_run_repeated_is_bitwise_k_runs(model, stacked, reduce):
    """Dropout 0.1 (in train mode): the K steps draw the same masks from
    the chain as K ``run`` calls, and end in the same params, moments
    and chain."""
    if model == "mlp":
        main, startup, loss = _mlp(pt, "Adam", dropout=0.1, is_test=False)
        feeds = _mlp_feeds(K)
    else:
        main, startup, loss = _bert(pt, tbert, "Adam",
                                    dict(CFG, dropout=0.1))
        feeds = _bert_feeds(K)
    exe = pt.Executor(pt.CPUPlace())
    base = pt.Scope()
    exe.run(startup, scope=base)
    seq, rep = _copy_scope(base), _copy_scope(base)
    losses = [exe.run(main, feed=feeds[i] if stacked else feeds[0],
                      fetch_list=[loss], scope=seq, return_numpy=False)[0]
              for i in range(K)]
    (got,) = exe.run_repeated(main, feed=_window(feeds, stacked),
                              fetch_list=[loss], scope=rep, steps=K,
                              feed_stacked=stacked, reduce_fetches=reduce,
                              return_numpy=False)
    total = losses[0] + losses[1] + losses[2]
    want = {"last": losses[-1], "sum": total, "mean": total / K}[reduce]
    assert torch.equal(got, want), (got, want)
    names = set(seq.local_var_names())
    assert names == set(rep.local_var_names())
    for n in names:
        a, b = seq.find_var(n), rep.find_var(n)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), n
        else:  # the RNG chain
            assert torch.equal(a.get_state(), b.get_state()), n


# ------------------------------------------------------------- errors
def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _both(call):
    """``call(pkg, exe, main, loss, scope)`` in each package on the MLP
    after its startup; the two error messages."""
    msgs = []
    for pkg, scope_cls in ((jf, JScope), (pt, pt.Scope)):
        main, startup, loss = _mlp(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = scope_cls()
        exe.run(startup, scope=scope)
        msgs.append(_raised(lambda: call(exe, main, loss, scope)))
    return msgs


@pytest.mark.parametrize("case", ["stacked_axis", "reduce", "singleton"])
def test_run_repeated_errors_are_the_reference_s(case):
    feed = _mlp_feeds(1)[0]
    calls = {
        "stacked_axis": lambda exe, main, loss, sc: exe.run_repeated(
            main, feed={k: np.stack([v, v]) for k, v in feed.items()},
            fetch_list=[loss], scope=sc, steps=3, feed_stacked=True),
        "reduce": lambda exe, main, loss, sc: exe.run_repeated(
            main, feed=feed, fetch_list=[loss], scope=sc, steps=3,
            reduce_fetches="max"),
        "singleton": lambda exe, main, loss, sc: exe.run_repeated(
            main, feed={k: np.stack([v, v]) for k, v in feed.items()},
            fetch_list=[loss], scope=sc, steps=1, feed_stacked=True),
    }
    jax_msg, port_msg = _both(calls[case])
    assert port_msg == jax_msg
    assert {"stacked_axis": "leading steps axis of 3",
            "reduce": "last|mean|sum",
            "singleton": "leading axis of 1"}[case] in port_msg


def test_stacked_feed_helpers_match_the_reference():
    from paddle_tpu.core import executor as jexec

    window = {"x": np.zeros((1, 4, 2), "float32")}
    got = texec.unstack_singleton_feed(window)
    want = jexec.unstack_singleton_feed(window)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["x"], want["x"])
    texec.validate_stacked_feeds(["x"], [np.zeros((3, 2))], 3)
    msgs = []
    for mod in (jexec, texec):
        with pytest.raises(ValueError) as e:
            mod.validate_stacked_feeds(["x"], [np.float32(1.0)], 3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------- FLAGS_check_nan_inf
def test_check_nan_inf_is_off_by_default_and_set_at_import():
    assert pt.flags.get_flag("check_nan_inf") is False
    assert jf.flags.get_flag("check_nan_inf") is False
    env = dict(os.environ, FLAGS_check_nan_inf="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['jax'] = None\n"
         "import paddle_tpu_torch as f\n"
         "print(f.get_flag('check_nan_inf'))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "True", r.stderr[-2000:]


@pytest.mark.parametrize("repeated", [False, True])
def test_check_nan_inf_raises_as_the_reference(repeated):
    msgs = []
    for pkg, scope_cls in ((jf, JScope), (pt, pt.Scope)):
        main, startup, loss = _mlp(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = scope_cls()
        exe.run(startup, scope=scope)
        feed = _mlp_feeds(1)[0]
        feed["x"] = np.full_like(feed["x"], np.nan)
        run = (lambda: exe.run_repeated(main, feed=feed, fetch_list=[loss],
                                        scope=scope, steps=3)) \
            if repeated else \
            (lambda: exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope))
        assert np.isnan(run()[0]).all()  # the flag is off: no check
        pkg.flags.set_flag("check_nan_inf", True)
        try:
            with pytest.raises(FloatingPointError) as e:
                run()
        finally:
            pkg.flags.set_flag("check_nan_inf", False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("scanned" in msgs[1]) == repeated


# ---------------------------------------------------- graph bookkeeping
def test_state_changes_sorts_replaced_vars():
    w, b, lr = torch.zeros(3, 4), torch.zeros(4), torch.ones(1)
    captured = {"w": w, "b": b, "lr": lr}
    assert state_changes(captured, dict(captured)) == ([], [])
    # a new tensor of the captured shape, dtype and device: copied in
    assert state_changes(captured, dict(captured, w=torch.ones(3, 4))) == (
        ["w"], [])
    # another shape, dtype, device or a non-tensor: a new capture
    for new in (torch.ones(4, 3), torch.ones(3, 4, dtype=torch.float64),
                torch.ones(3, 4, device="meta"), np.ones((3, 4), "float32")):
        assert state_changes(captured, dict(captured, w=new)) == ([], ["w"])
    assert state_changes(captured, dict(captured, w=torch.ones(3, 4),
                                        lr=torch.ones(2))) == (["w"], ["lr"])
    # a view of the captured tensor is another tensor
    assert state_changes(captured, dict(captured, w=w.view(3, 4))) == (
        ["w"], [])


def test_the_optimizer_group_updates_in_place_only_donated_state():
    main, _, _ = _mlp(pt, "Adam", dropout=0.0)
    adam = [op for op in main.global_block().ops if op.type == "adam"][0]
    names = {s: adam.input(s)[0] for s in ("Param", "Moment1", "Moment2")}
    t = {s: torch.zeros(2) for s in names}
    ins = {s: [t[s]] for s in names}
    donated = {names[s]: t[s] for s in names}

    class Op:  # a one-param fused group: the adam op's own slots
        def input(self, slot):
            return adam.input(slot)

        def output(self, slot):
            return adam.output(slot)

    assert _donated(Op(), ins, "adam", donated)
    assert not _donated(Op(), ins, "adam", {})
    assert not _donated(None, ins, "adam", donated)
    other = dict(donated, **{names["Moment2"]: torch.zeros(2)})
    assert not _donated(Op(), ins, "adam", other)
    assert _donated(Op(), {"Param": ins["Param"]}, "sgd",
                    {names["Param"]: t["Param"]})


def test_the_step_trace_records_random_ops_and_constants():
    """The eager step with a ``StepTrace`` gives the step's own result
    and records each random op's seed source and each constant placed
    on the device, in program order."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        h = pt.layers.dropout(x, 0.5)
        h = pt.layers.dropout(h, 0.5, seed=9)
        blk = main.global_block()
        c = blk.create_var(name="c", shape=[2], dtype="float32")
        blk.append_op(type="assign_value", outputs={"Out": [c]},
                      attrs={"values": [1.0, 2.0], "shape": [2],
                             "dtype": "float32"})
        h = pt.layers.dropout(h, 0.5)
    plan = texec._Plan(*texec.analyze_block(main, ["x"], [h.name, "c"],
                                            pt.Scope()), exact=False)
    feeds = {"x": torch.ones(3, 4)}
    runs = []
    for trace in (None, StepTrace()):
        chain = torch.Generator().manual_seed(1)
        fetches, _ = plan.step(feeds, {}, chain, CPU, trace)
        runs.append((fetches, chain.get_state()))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert torch.equal(runs[0][1], runs[1][1])
    assert trace.slots == [CHAIN, 9, CHAIN]
    assert trace.constants == [((2,), torch.float32)]
    assert trace.donated == {}


def test_an_evicted_plan_releases_its_graph(monkeypatch):
    released = []
    monkeypatch.setattr(texec._Plan, "release",
                        lambda self: released.append(self))
    main, startup, loss = _mlp(pt, "SGD", dropout=0.0)
    exe = pt.Executor(pt.CPUPlace(), cache_size=1)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    (first,) = exe._cache.values()
    exe.run(main, feed=_mlp_feeds(1)[0], fetch_list=[loss], scope=scope)
    assert released == [first]
    exe.close()
    assert len(released) == 2 and not exe._cache
