"""The port's optimizing pass pipeline and the Executor's plan cache,
held against the JAX package on the CPU.

- The pipeline (core/passes, level 2) turns the same 2-layer BERT MLM
  training program (d_model 64, S = 32, Adam and SGD) into the same
  optimized program in both packages: the same ops with the same attrs,
  and the same per-pass stats (6 ops folded into 3 ``assign_value``s,
  2 dead ops removed, 2 * n_layer + 1 ``fused_layernorm_residual`` ops
  and one ``fused_optimizer_update`` over every param).
- Elementwise fusion gives the same program and outputs in both.
- On the CPU the fused ops replay their constituents, so three training
  steps at level 2 are bitwise three steps at level 0 (dropout on: the
  RNG draws stay in program order).
- ``Executor.run`` prepares once per plan-cache key: three steps run the
  pipeline once (``paddle_optimizer_programs_optimized_total``); a
  changed optimizer level or flash threshold re-prepares; level 0 and
  ``exact_numerics`` programs bypass the pipeline.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.core.passes import optimize_program as jax_optimize
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.analysis import shape_rules
from paddle_tpu_torch.core.passes import optimize_program
from paddle_tpu_torch.core.registry import OPS
from paddle_tpu_torch.kernels import tune
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.observe.families import (EXECUTOR_CACHE_HITS,
                                               EXECUTOR_CACHE_MISSES,
                                               OPTIMIZER_PROGRAMS)

CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
           type_vocab=2, max_length=40, dropout=0.0)
S, M, B = 32, 6, 3
OPTIMIZERS = ("Adam", "SGD")


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
def _no_tuned_winners(monkeypatch):
    """No tuned entry anywhere and the pipeline's defaults."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", "0")
    for name in ("PADDLE_TPU_OPTIMIZE", "PADDLE_TPU_KERNELS",
                 "PADDLE_TPU_OPTIMIZE_QUANT"):
        monkeypatch.delenv(name, raising=False)
    tune.reset()
    yield
    tune.reset()


def _build(pkg, bert_mod, opt="Adam", cfg=CFG):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = bert_mod.build(cfg, seq_len=S, max_mask=M)
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


def _strip(stats):
    return [{k: v for k, v in row.items() if k != "seconds"}
            for row in stats]


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_pipeline_matches_jax_on_bert_mlm(opt):
    jmain, _, jloss = _build(jf, jbert, opt)
    tmain, _, tloss = _build(pt, tbert, opt)
    jo, jstats = jax_optimize(jmain, fetch_list=[jloss])
    to, tstats = optimize_program(tmain, fetch_list=[tloss])
    assert to.to_dict() == jo.to_dict()
    assert _strip(tstats) == _strip(jstats)
    rows = {r["pass"]: r for r in tstats}
    assert (rows["constant_folding_pass"]["folded"],
            rows["constant_folding_pass"]["materialized"]) == (6, 3)
    assert rows["dead_op_elimination_pass"]["dce_removed"] == 2
    tier = rows["fuse_kernel_tier_pass"]
    n_params = len(tmain.global_block().all_parameters())
    assert tier["ln_residual_fused"] == 2 * CFG["n_layer"] + 1
    assert tier["optimizer_groups"] == 1
    assert tier["ops_fused_away"] == tier["ln_residual_fused"] + n_params - 1
    before = len(tmain.global_block().ops)
    after = len(to.global_block().ops)
    assert before - after == 3 + 2 + tier["ops_fused_away"]
    types = [op.type for op in to.global_block().ops]
    (fused_opt,) = [op for op in to.global_block().ops
                    if op.type == "fused_optimizer_update"]
    assert len(fused_opt.input("Param")) == n_params
    assert opt.lower() not in types
    # the user's program is untouched
    assert len(tmain.global_block().ops) == before


def _chain_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [6])
        h = pkg.layers.fc(x, 8)
        y = pkg.layers.tanh(pkg.layers.scale(h, scale=0.5, bias=0.25))
        out = pkg.layers.relu(pkg.layers.elementwise_add(y, h))
    return main, startup, out


def test_elementwise_fusion_matches_jax():
    jmain, jstart, jout = _chain_program(jf)
    tmain, tstart, tout = _chain_program(pt)
    jo, jstats = jax_optimize(jmain, fetch_list=[jout])
    to, tstats = optimize_program(tmain, fetch_list=[tout])
    assert to.to_dict() == jo.to_dict()
    assert _strip(tstats) == _strip(jstats)
    assert "fused_elementwise" in [op.type for op in to.global_block().ops]
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    for name in jscope.local_var_names():
        tscope.set_var(name, torch.from_numpy(
            np.array(jscope.find_var(name))))
    feed = {"x": np.random.RandomState(0).randn(4, 6).astype("float32")}
    (want,) = jexe.run(jmain, feed=feed, fetch_list=[jout], scope=jscope)
    (got,) = texe.run(tmain, feed=feed, fetch_list=[tout], scope=tscope)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _steps(main, loss, snap, feeds):
    scope = pt.Scope()
    for n, v in snap.items():
        scope.set_var(n, v)
    exe = pt.Executor(pt.CPUPlace())
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
              for f in feeds]
    return losses, {n: scope.find_var(n) for n in scope.local_var_names()}


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_level2_composed_is_bitwise_level0(opt, monkeypatch):
    main, startup, loss = _build(pt, tbert, opt, dict(CFG, dropout=0.1))
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    snap = {n: scope.find_var(n) for n in scope.local_var_names()}
    feeds = _feeds(3, seed=1)
    runs = {}
    for level in ("0", "2"):
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", level)
        runs[level] = _steps(main, loss, snap, feeds)
    (l0, s0), (l2, s2) = runs["0"], runs["2"]
    assert [v.item() for v in l2] == [v.item() for v in l0]
    assert set(s2) == set(s0)
    for n, v in s0.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(s2[n], v), n
        else:  # the RNG chain
            assert torch.equal(s2[n].get_state(), v.get_state())


def test_plan_cache_runs_the_pipeline_once():
    main, startup, loss = _build(pt, tbert)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    optimized = OPTIMIZER_PROGRAMS.labels(level="2")
    o0, h0 = optimized.value, EXECUTOR_CACHE_HITS.value
    for feed in _feeds(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert optimized.value - o0 == 1
    assert EXECUTOR_CACHE_HITS.value - h0 == 2


def test_config_changes_reprepare(monkeypatch):
    main, startup, loss = _build(pt, tbert)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _feeds(1)[0]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    for name, value in (("PADDLE_TPU_FLASH_MIN_SEQ", "100000"),
                        ("PADDLE_TPU_OPTIMIZE", "1"),
                        ("PADDLE_TPU_KERNELS", "0")):
        m0 = EXECUTOR_CACHE_MISSES.value
        monkeypatch.setenv(name, value)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert EXECUTOR_CACHE_MISSES.value - m0 == 1, name
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert EXECUTOR_CACHE_MISSES.value - m0 == 1, name


@pytest.mark.parametrize("how", ["level0", "exact_numerics"])
def test_bypasses_run_the_users_program(how, monkeypatch):
    main, startup, loss = _build(pt, tbert)
    if how == "level0":
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", "0")
    else:
        main.exact_numerics = True
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    counts = [OPTIMIZER_PROGRAMS.labels(level=lv).value for lv in "12"]
    seen = []
    from paddle_tpu_torch.core import lowering

    orig = lowering.lower_op
    monkeypatch.setattr(lowering, "lower_op", lambda ctx, op, env: (
        seen.append(op.type), orig(ctx, op, env)))
    exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    assert [OPTIMIZER_PROGRAMS.labels(level=lv).value for lv in "12"] \
        == counts
    assert seen == [op.type for op in main.global_block().ops]


def test_shape_rules_skip_only_unported_op_types():
    # every op type the JAX package gives a shape rule is lowered in the
    # port since the misc and quantization ops (the 27 it lacks have
    # none), so no rule is skipped
    assert shape_rules.SKIPPED == []
    assert not set(shape_rules.SKIPPED) & set(OPS)
    # every op type both packages lower carries the JAX package's rule
    both = [t for t in OPS if t in JAX_OPS and JAX_OPS[t].infer_shape]
    assert {"layer_norm", "mul", "lookup_table", "adam"} <= set(both)
    for t in both:
        assert OPS[t].infer_shape is not None, t
        assert OPS[t].infer_shape.__name__ == \
            JAX_OPS[t].infer_shape.__name__, t
