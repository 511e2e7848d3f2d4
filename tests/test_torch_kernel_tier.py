"""The port's kernel tier (kernels/), held against the JAX package on the
CPU.

- The plain versions of the four tier kernels against the JAX package's
  Pallas kernels, run in interpret mode as tests/test_kernels.py runs
  them: K4 (``layernorm_residual_fwd``) at atol 1e-5, K5 (the backward,
  through ``torch.autograd`` on the port's side and ``jax.vjp`` of
  ``layernorm_residual`` on the JAX side, the mean / variance cotangents
  included) at 5e-5, K6 / K7 (the grouped Adam / SGD updates, beta
  powers included) at 2e-6: the JAX package's stated tolerances.
- The fused ops take their route from the device: the replay of their
  constituents for CPU tensors, the kernel for tensors on the card. The
  kernel route is driven here by treating CPU tensors as the card's
  (the wrappers then take their plain versions).
- The kernel route end to end: a 2-layer BERT MLM whose startup scope
  moves into the port with ``params_from_jax``; the port at level 2 on
  the kernel route against the JAX package at level 2 with ``"pallas"``
  winners, 3 Adam and 3 SGD steps: losses within a relative 1e-5, params
  within atol 1e-4 (the bound of tests/test_torch_training.py's
  transplant test).
- The tuner in deterministic mode on its one op, ``attention``:
  selection, persistence, a failing candidate failing the tune, a table
  change read by the next run without a re-prepare, the tier bypass and
  the flash precedence's tuned tier.
- The wrappers: input checks, and launch counts that move only where a
  kernel launches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu import kernels as jkernels
from paddle_tpu.kernels import layernorm as JL
from paddle_tpu.kernels import optimizer_update as JO
from paddle_tpu.kernels import tune as jtune
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import kernels
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import get_op
from paddle_tpu_torch.kernels import layernorm as L
from paddle_tpu_torch.kernels import optimizer_update as O
from paddle_tpu_torch.kernels import tune
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.observe.families import (EXECUTOR_CACHE_MISSES,
                                               KERNEL_DISPATCHES,
                                               KERNEL_TUNER_HITS)
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import fused_ops

CPU = torch.device("cpu")
CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
           type_vocab=2, max_length=40, dropout=0.0)
S, M, B = 32, 6, 3


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


@pytest.fixture(autouse=True)
def _clean_tuners(monkeypatch, tmp_path):
    """Both packages' tuners start empty, each with a winner cache of its
    own, and nothing leaks into the next test."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", str(tmp_path / "kc"))
    for name in ("PADDLE_TPU_KERNELS", "PADDLE_TPU_KERNEL_TUNE",
                 "PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC",
                 "PADDLE_TPU_OPTIMIZE"):
        monkeypatch.delenv(name, raising=False)
    tune.reset()
    jtune.reset()
    jkernels.reset_decisions()
    yield
    tune.reset()
    jtune.reset()
    jkernels.reset_decisions()


def _rows(rs, n, d):
    return [rs.randn(*shape).astype("float32")
            for shape in ((n, d), (n, d), (d,), (d,))]


# ------------------------------------------------------------- K4 / K5
@pytest.mark.parametrize("n,d", [(64, 64), (37, 100), (8, 768)])
def test_k4_plain_version_matches_jax_kernel(n, d):
    x, r, sc, b = _rows(np.random.RandomState(n), n, d)
    want = JL.layernorm_residual((8,), *map(jnp.asarray, (x, r, sc, b)),
                                 eps=1e-5)
    before = L.layernorm_residual_fwd.launches
    got = L.layernorm_residual_fwd(*map(torch.from_numpy, (x, r, sc, b)),
                                   eps=1e-5)
    assert L.layernorm_residual_fwd.launches == before  # no launch on CPU
    for name, g, w in zip(("y", "s", "mean", "var"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("stat_cotangents", [False, True])
def test_k5_plain_version_matches_jax_vjp(stat_cotangents):
    n, d = 40, 96
    rs = np.random.RandomState(7)
    x, r, sc, b = _rows(rs, n, d)
    gy, gs = rs.randn(n, d).astype("float32"), rs.randn(n, d).astype(
        "float32")
    gm, gv = (rs.randn(n, 1).astype("float32") if stat_cotangents
              else np.zeros((n, 1), "float32") for _ in range(2))
    _, vjp = jax.vjp(lambda *a: JL.layernorm_residual((8,), *a, eps=1e-5),
                     *map(jnp.asarray, (x, r, sc, b)))
    want = vjp(tuple(map(jnp.asarray, (gy, gs, gm, gv))))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, r, sc, b)]
    outs = L.layernorm_residual(*ins, eps=1e-5)
    before = L.layernorm_residual_bwd.launches
    torch.autograd.backward(outs, [torch.from_numpy(a)
                                   for a in (gy, gs, gm, gv)])
    assert L.layernorm_residual_bwd.launches == before
    for name, t, w in zip(("dx", "dr", "dscale", "dbias"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=5e-5, rtol=0, err_msg=name)


def test_k4_k5_wrappers_check_their_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="dtype"):
        L.layernorm_residual_fwd(x.double(), x.double(), torch.zeros(8),
                                 torch.zeros(8))
    with pytest.raises(ValueError, match="r is"):
        L.layernorm_residual_fwd(x, torch.zeros(4, 9), torch.zeros(8),
                                 torch.zeros(8))
    with pytest.raises(ValueError, match="scale has 7 elements"):
        L.layernorm_residual_fwd(x, x, torch.zeros(7), torch.zeros(8))
    with pytest.raises(ValueError, match="mean has shape"):
        L.layernorm_residual_bwd(x, torch.zeros(5, 1), torch.zeros(4, 1),
                                 torch.zeros(8), x, x)
    with pytest.raises(ValueError, match="rows of at least 1 column"):
        L._check_kernel_width("layernorm_residual_fwd", 0)
    L._check_kernel_width("layernorm_residual_fwd", 4096)  # wide kernels


# ------------------------------------------------------------- K6 / K7
_GROUP = [(6, 5), (7,), (1,), (33, 3)]


def _group(kind, rs):
    mk = lambda s: (rs.rand(*s) + 0.1).astype("float32")  # noqa: E731
    ins = {"Param": [mk(s) for s in _GROUP],
           "Grad": [mk(s) - 0.6 for s in _GROUP],
           "LearningRate": [np.full(1, 1e-2, "float32")] * len(_GROUP)}
    if kind == "adam":
        ins["Moment1"] = [mk(s) * 0.1 for s in _GROUP]
        ins["Moment2"] = [mk(s) * 0.01 for s in _GROUP]
        ins["Beta1Pow"] = [np.full(1, 0.9 ** k, "float32")
                           for k in range(1, 5)]
        ins["Beta2Pow"] = [np.full(1, 0.999 ** k, "float32")
                           for k in range(1, 5)]
    return ins


@pytest.mark.parametrize("kind,hyper", [
    ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adam", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    ("sgd", {})])
def test_k6_k7_plain_versions_match_jax_kernels(kind, hyper):
    ins = _group(kind, np.random.RandomState(3))
    want = JO.sweep_group((8,), kind, {k: [jnp.asarray(a) for a in v]
                                       for k, v in ins.items()}, hyper)
    wrapper = O.adam_group if kind == "adam" else O.sgd_group
    t_ins = {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()}
    before = wrapper.launches
    got = (O.adam_group(t_ins, hyper) if kind == "adam"
           else O.sgd_group(t_ins))
    assert wrapper.launches == before
    assert set(got) == set(O.OPT_OUT_SLOTS[kind]) == set(want)
    for slot in got:
        for g, w in zip(got[slot], want[slot]):
            assert tuple(g.shape) == w.shape, slot
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6,
                                       rtol=0, err_msg=slot)


def test_k6_k7_wrappers_check_their_groups():
    ins = {k: [torch.from_numpy(a) for a in v]
           for k, v in _group("adam", np.random.RandomState(0)).items()}
    bad = dict(ins, Grad=ins["Grad"][:-1])
    with pytest.raises(ValueError, match="3 Grad tensors for 4 params"):
        O.adam_group(bad, {})
    bad = dict(ins, Moment1=[m.double() for m in ins["Moment1"]])
    with pytest.raises(ValueError, match="dtype"):
        O.adam_group(bad, {})
    bad = dict(ins, Moment2=[ins["Moment2"][0][:1]] + ins["Moment2"][1:])
    with pytest.raises(ValueError, match="Moment2\\[0\\] has 5 elements"):
        O.adam_group(bad, {})
    # the kernels take f32 only
    bad = dict(ins, Param=[p.to(torch.bfloat16) for p in ins["Param"]])
    with pytest.raises(ValueError, match="dtype"):
        O.adam_group(bad, {})


def test_k6_cpu_wrapper_matches_jax_composed_adam_group():
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "weight_decay": 0.01}
    ins = _group("adam", np.random.RandomState(5))
    want = JO.composed_adam_group(
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.01)
    got = O.adam_group({k: [torch.from_numpy(a) for a in v]
                        for k, v in ins.items()}, hyper)
    for slot, w in zip(("ParamOut", "Moment1Out", "Moment2Out"), want):
        for g, wv in zip(got[slot], w):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv),
                                       atol=2e-6, rtol=0, err_msg=slot)


@pytest.mark.parametrize("sizes", [[30522, 768, 1, 33], [1], [32, 64, 5],
                                   [7, 3, 4097, 16385, 123457]])
def test_k6_padded_output_views_are_aligned_disjoint_and_shaped(sizes):
    offs, total = O.padded_offsets(sizes)
    assert (offs % 32 == 0).all() and offs[0] == 0
    ends = offs + np.asarray(sizes)
    assert (ends[:-1] <= offs[1:]).all() and ends[-1] <= total
    assert (offs[1:] - ends[:-1] < 32).all()  # under 128 bytes of padding
    shapes = [(n,) if i % 2 else (1, n) for i, n in enumerate(sizes)]
    like = [torch.empty(sh) for sh in shapes]
    flat = torch.zeros(2, total)
    for row in O._outputs(flat, like, sizes):
        assert [tuple(v.shape) for v in row] == shapes
        assert [v.storage_offset() % total for v in row] == list(offs)
        for i, v in enumerate(row):
            v.fill_(i + 1)
    # every element written once, the padding untouched
    assert int((flat != 0).sum()) == 2 * sum(sizes)
    # the kernel's pointer columns are the views' addresses
    np.testing.assert_array_equal(O._flat_ptrs(flat[1], sizes),
                                  [v.data_ptr() for v in
                                   O._outputs(flat, like, sizes)[1]])


def test_k6_k7_alignment_classification():
    base = 1 << 20
    adam = {s: [base + 16 * i for i in range(4)]
            for s in O._STREAMS["adam"]}
    assert O.vector_entries("adam", adam).tolist() == [True] * 4
    adam["Moment2"] = [base, base + 4, base + 8, base + 48]
    adam["ParamOut"][0] = base + 12
    assert O.vector_entries("adam", adam).tolist() == [False, False, False,
                                                       True]
    sgd = {s: [base, base + 32] for s in O._STREAMS["sgd"]}
    sgd["Grad"] = [base + 2, base + 64]
    assert O.vector_entries("sgd", sgd).tolist() == [False, True]
    # the table carries the flag, its first tiles and the vector count
    sizes = [5000, 1, 2048]
    cols = {f: [base + 64 * i for i in range(3)]
            for f in O.ADAM_FIELDS[:12]}
    cols["Grad"] = [base + 4, base + 64, base + 128]
    rows, tiles, vec = O.table_rows("adam", cols, sizes)
    assert (tiles, vec) == (3 + 1 + 1, 2)
    assert rows[:, O.ADAM_FIELDS.index("first_tile")].tolist() == [0, 3, 4]
    assert rows[:, O.ADAM_FIELDS.index("vector")].tolist() == [0, 1, 1]
    assert rows[:, O.ADAM_FIELDS.index("n")].tolist() == sizes


# --------------------------------------------- the route of the fused ops
def _dispatches():
    return {(op, impl): KERNEL_DISPATCHES.labels(op=op, impl=impl).value
            for op in ("layernorm_residual", "adam_update", "sgd_update")
            for impl in ("cuda", "composed")}


def _moved(before):
    return {k: v - before[k] for k, v in _dispatches().items()
            if v != before[k]}


def _fused_case(kind, rs):
    """(op type, inputs, attrs, the unfused lowerings' outputs)."""
    ctx = LowerContext(None, None, CPU)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    if kind == "layernorm":
        x, r = rs.randn(2, 5, 16).astype("float32"), rs.randn(
            2, 5, 16).astype("float32")
        sc, b = rs.randn(16).astype("float32"), rs.randn(16).astype(
            "float32")
        ins = {"X": [t(x)], "Residual": [t(r)], "Scale": [t(sc)],
               "Bias": [t(b)]}
        attrs = {"add_attrs": {"axis": -1},
                 "ln_attrs": {"begin_norm_axis": 2, "epsilon": 1e-5}}
        s_ = get_op("elementwise_add").lowering(
            ctx, {"X": [t(x)], "Y": [t(r)]}, {"axis": -1})["Out"][0]
        ln = get_op("layer_norm").lowering(
            ctx, {"X": [s_], "Scale": [t(sc)], "Bias": [t(b)]},
            attrs["ln_attrs"])
        want = {"ResOut": [s_], "Y": ln["Y"], "Mean": ln["Mean"],
                "Variance": ln["Variance"]}
        return "fused_layernorm_residual", ins, attrs, want
    g = {k: [t(a) for a in v] for k, v in _group(kind, rs).items()}
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8} \
        if kind == "adam" else {}
    want = {slot: [] for slot in O.OPT_OUT_SLOTS[kind]}
    for i in range(len(_GROUP)):
        o = get_op(kind).lowering(
            ctx, {s_: [g[s_][i]] for s_ in O.OPT_IN_SLOTS[kind]}, hyper)
        for slot in want:
            want[slot].append(o[slot][0])
    return ("fused_optimizer_update", g, {"kind": kind, "hyper": hyper},
            want)


@pytest.mark.parametrize("kind", ["layernorm", "adam", "sgd"])
def test_fused_ops_take_their_route_from_the_device(monkeypatch, kind):
    """CPU tensors replay the unfused lowerings, bitwise; the card's
    tensors take the kernel (here its plain version, at the kernel's
    tolerance), whatever the tuned table holds."""
    op, ins, attrs, want = _fused_case(kind, np.random.RandomState(4))
    label = {"layernorm": "layernorm_residual", "adam": "adam_update",
             "sgd": "sgd_update"}[kind]
    lowering = get_op(op).lowering
    ctx = LowerContext(None, None, CPU)
    before = _dispatches()
    got = lowering(ctx, ins, attrs)
    assert _moved(before) == {(label, "composed"): 1}
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert torch.equal(g, w), slot
    monkeypatch.setattr(fused_ops, "_on_card", lambda t: True)
    before = _dispatches()
    got = lowering(ctx, ins, attrs)
    assert _moved(before) == {(label, "cuda"): 1}
    tol = 1e-5 if kind == "layernorm" else 2e-6
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert tuple(g.shape) == tuple(w.shape), slot
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                       atol=tol, rtol=0, err_msg=slot)


# ----------------------------------- the kernel route end to end (BERT)
def _build(pkg, bert_mod, opt):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = bert_mod.build(CFG, seq_len=S, max_mask=M)
        getattr(pkg.optimizer, opt)(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _feeds(n, seed=0):
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


def _jax_signatures(main, opt):
    """The JAX package's tier signatures of a step of ``main``: the fused
    layer norms' rows and the one optimizer group."""
    ps = main.global_block().all_parameters()
    n_total = sum(int(np.prod(p.shape)) for p in ps)
    return [("layernorm_residual", ("float32", B * S, CFG["d_model"])),
            (opt.lower() + "_update", ("float32", n_total, len(ps)))]


@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_kernel_route_matches_jax_pallas_winners(monkeypatch, opt):
    jmain, jstart, jloss = _build(jf, jbert, opt)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    sigs = _jax_signatures(jmain, opt)
    for op, sig in sigs:
        jtune.set_entry(op, sig, {"choice": "pallas", "cfg": [8]})
    feeds = _feeds(3, seed=2)
    jlosses = [jexe.run(jmain, feed=f, fetch_list=[jloss],
                        scope=jscope)[0].item() for f in feeds]
    assert {op: jkernels.decisions_seen()[op]["choice"]
            for op, _ in sigs} == {op: "pallas:8" for op, _ in sigs}
    tmain, _, tloss = _build(pt, tbert, opt)
    tscope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        tscope.set_var(n, v)
    monkeypatch.setattr(fused_ops, "_on_card", lambda t: True)
    texe = pt.Executor(pt.CPUPlace())
    before = _dispatches()
    tlosses = [texe.run(tmain, feed=f, fetch_list=[tloss],
                        scope=tscope)[0].item() for f in feeds]
    assert _moved(before) == {
        ("layernorm_residual", "cuda"): 3 * (2 * CFG["n_layer"] + 1),
        (opt.lower() + "_update", "cuda"): 3}
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    for p in tmain.global_block().all_parameters():
        np.testing.assert_allclose(
            tscope.find_var(p.name).numpy(),
            np.asarray(jscope.find_var(p.name)), atol=1e-4, rtol=0,
            err_msg=p.name)


# ------------------------------------------------------------- the tuner
def test_deterministic_tune_selects_persists_and_reloads(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", "7")
    assert kernels.all_kernels() == ["attention"]
    sig = (96, 64)
    dec = tune.tune("attention", sig, {"scale": 0.125})
    labels = [t["label"] for t in dec["timings"]]
    assert labels == ["cuda:[]", "composed"]
    best = min(dec["timings"], key=lambda t: t["seconds"])
    assert (dec["choice"], dec["cfg"]) == (best["choice"], best["cfg"])
    assert tune.tune("attention", sig)["choice"] == dec["choice"]
    # persisted under the port's own cache file, read back after a reset
    entries = tune.load_disk_entries(
        str(tmp_path / "kc" / tune.CACHE_FILE))
    assert entries[tune.sig_key("attention", sig)]["choice"] \
        == dec["choice"]
    tune.reset()
    hits = KERNEL_TUNER_HITS.labels(tier="disk").value
    assert tune.lookup("attention", sig)["choice"] == dec["choice"]
    assert KERNEL_TUNER_HITS.labels(tier="disk").value == hits + 1
    # the flash precedence serves the winner
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_SEQ", raising=False)
    assert tattn.flash_effective(96, 64) == (dec["choice"] == "cuda")
    # by default the two packages keep their winners apart
    monkeypatch.delenv("PADDLE_TPU_KERNEL_CACHE_DIR")
    assert tune.cache_dir().endswith("paddle_tpu_torch/kernels")
    assert jtune.cache_dir().endswith("paddle_tpu/kernels")


def test_tune_needs_a_card_unless_deterministic(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="measures on the card"):
        tune.tune("attention", (100, 100))


def test_a_failing_candidate_fails_the_tune(monkeypatch, tmp_path):
    """A kernel that does not build or launch fails the tune with its
    error; no composed winner is recorded or persisted for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tune, "_on_card", lambda args: args)
    monkeypatch.setattr(tune, "_measure", lambda fn, args, attrs, n: (
        fn(*args, **attrs), 1e-3)[1])

    def broken(cfg, q, k, v, **attrs):
        raise RuntimeError("nvcc failed for flash_attention_fwd")

    monkeypatch.setattr(kernels.get_kernel("attention"), "pallas", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tune.tune("attention", (64, 64))
    assert tune.lookup("attention", (64, 64)) is None
    assert not (tmp_path / "kc" / tune.CACHE_FILE).exists()


def test_a_table_change_takes_effect_without_a_reprepare(monkeypatch):
    """The lowerings read the tuned table at every run: a new entry
    changes the next run's attention route and keeps the cached plan."""
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_SEQ", raising=False)
    main, startup, loss = _build(pt, tbert, "SGD")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _feeds(1)[0]
    flash_calls = []
    orig = tattn._fa_maskbias
    monkeypatch.setattr(tattn, "_fa_maskbias", lambda *a, **kw: (
        flash_calls.append(1), orig(*a, **kw))[1])
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert flash_calls == []  # S = 32: below the static threshold
    m0, key = EXECUTOR_CACHE_MISSES.value, kernels.config_key()
    tune.set_entry("attention", (S, S), {"choice": "cuda", "cfg": []})
    assert kernels.config_key() == key
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert EXECUTOR_CACHE_MISSES.value == m0  # the cached plan
    assert len(flash_calls) == CFG["n_layer"]


def test_the_bypass_fuses_nothing_and_moves_no_counter(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KERNELS", "0")
    main, startup, loss = _build(pt, tbert, "Adam")
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    before = _dispatches()
    seen = []
    from paddle_tpu_torch.core import lowering

    orig = lowering.lower_op
    monkeypatch.setattr(lowering, "lower_op", lambda ctx, op, env: (
        seen.append(op.type), orig(ctx, op, env)))
    exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    assert "adam" in seen and "layer_norm" in seen
    assert not {"fused_layernorm_residual", "fused_optimizer_update"} & set(
        seen)
    assert _moved(before) == {}


def test_flash_precedence_env_then_tuned_entry_then_threshold(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_SEQ", raising=False)
    assert not tattn.flash_effective(128) and tattn.flash_effective(512)
    tune.set_entry("attention", (128, 128), {"choice": "cuda", "cfg": []})
    tune.set_entry("attention", (512, 512), {"choice": "composed",
                                             "cfg": None})
    assert tattn.flash_effective(128) and not tattn.flash_effective(512)
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "256")
    assert not tattn.flash_effective(128) and tattn.flash_effective(512)
    monkeypatch.setenv("PADDLE_TPU_KERNELS", "0")
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_SEQ")
    assert not tattn.flash_effective(128)  # the bypass ignores the table
