"""bf16 AMP in the port (core/amp.py, contrib.mixed_precision), held
against the JAX package on the CPU.

- The policy: ``BF16_OPS``, ``FP32_OPS`` and ``policy_for`` over every
  op type either package registers (and its ``_grad``) equal the JAX
  package's; ``amp_cast`` with each class and with a stamped ``__amp__``
  gives the JAX package's dtypes and values exactly.
- tests/test_amp.py's four tests, run against the port.
- An MLP under AMP at level 0 and at level 2 fetches the dtypes the JAX
  package fetches (the loss f32, logits and every grad bf16), and from
  a transplanted scope (``convert.params_from_jax``) 3 Adam steps give
  the JAX package's losses at a relative 1e-2 and its params at 2e-3.
  The loss is the mean of an f32 softmax_with_cross_entropy; the logits
  come out of a bf16 matmul, rounded to 2^-8 of their size, and XLA
  keeps bf16 intermediates unrounded inside its fusions where the port
  rounds each op's output, so the two packages' bf16 values differ by
  an ulp here and there. Adam moves a param by at most about lr (1e-2)
  a step whatever its grad, so wrong grads would move 3 steps' params
  by up to 6e-2; bf16 noise in the grads moves them by well under
  2e-3.
- A 2-layer BERT MLM (hidden 64, 2 heads, S = 32, dropout 0) under AMP:
  the port at level 2 (CPU replays of the fused ops) against the JAX
  package's lowerings run op by op (``jax.disable_jit``: each op's
  output rounded to its dtype, as the port rounds it): the first step's
  loss at a relative 1e-2 (it is a bf16 value), every ``@GRAD`` of the
  JAX dtype, each param's grad within 3e-2 of the JAX grad in l2 norm
  (1.4e-2 measured: an ulp of difference in a bf16 relu pre-activation
  near 0 flips that unit's grad). Both sides take the composed
  attention (``PADDLE_TPU_FLASH_MIN_SEQ`` above S): the JAX flash
  kernel rounds its unnormalized probabilities to bf16, which the
  composed math and the port's plain version do not. Then 3 Adam steps
  against the JAX Executor: losses at 1e-2, and each param's update
  (its value after the steps minus before) within 0.3 of the JAX
  package's in l2 norm. Adam scales each element's step by its grad's
  running size, so an element whose grad is near 0 takes a step of
  about lr whose sign the bf16 rounding decides: 0.25 measured, where a
  wrong grad term sends an update off by its whole size. At level 0 and
  level 2 the port takes bitwise the same steps.
- The fused ops under AMP on the CPU: ``fused_layernorm_residual``
  replays the bf16 add and the f32 layer norm bitwise; K4's AMP plain
  version against the JAX package's fused op (s exact, y, mean and var
  at 1e-5); ``fused_optimizer_update`` over mixed bf16 / f32 grads
  against the JAX package's replay and K6 / K7's plain versions at
  2e-6.
- The pass pipeline under AMP (the stamps, folding with the casts, the
  fusions) gives the JAX package's optimized program, and folds a bf16
  constant to the JAX package's values; the lint's AMP rule fires where
  the JAX package's does.
- An AMP inference model saved by the JAX package serves through the
  port's Predictor like the JAX package's Predictor: the encoder's f32
  output within 2e-2 (bf16 ulps through 2 layers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.analysis import lint_program as jax_lint
from paddle_tpu.core import amp as jamp
from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.lowering import lower_block as jax_lower_block
from paddle_tpu.core.passes import optimize_program as jax_optimize
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.analysis import lint_program
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core import amp as tamp
from paddle_tpu_torch.core.executor import to_numpy
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.passes import optimize_program
from paddle_tpu_torch.core.registry import OPS, get_op
from paddle_tpu_torch.kernels import layernorm as tln
from paddle_tpu_torch.kernels import optimizer_update as topt
from paddle_tpu_torch.kernels import tune
from paddle_tpu_torch.models import bert as tbert

CPU = torch.device("cpu")
NO_FLASH = "100000"  # a PADDLE_TPU_FLASH_MIN_SEQ above every S here


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
def _defaults(monkeypatch):
    """No tuned winner and the pipeline's defaults."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", "0")
    for name in ("PADDLE_TPU_OPTIMIZE", "PADDLE_TPU_KERNELS",
                 "PADDLE_TPU_OPTIMIZE_QUANT"):
        monkeypatch.delenv(name, raising=False)
    tune.reset()
    yield
    tune.reset()


def _np(v):
    """A fetched value (JAX array, numpy or port tensor) as f32 numpy."""
    if isinstance(v, torch.Tensor):
        v = to_numpy(v)
    return np.asarray(v).astype(np.float32)


def _dtype(v):
    return str(v.dtype).replace("torch.", "") if isinstance(
        v, torch.Tensor) else str(np.asarray(v).dtype)


def _l2_rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- policy
def test_policy_tables_equal_the_jax_packages():
    assert tamp.BF16_OPS == jamp.BF16_OPS
    assert tamp.FP32_OPS == jamp.FP32_OPS
    for t in sorted(set(OPS) | set(JAX_OPS)):
        for name in (t, t + "_grad"):
            assert tamp.policy_for(name) == jamp.policy_for(name), name


@pytest.mark.parametrize("op_type,attrs", [
    ("mul", {}), ("mul_grad", {}), ("layer_norm", {}),
    ("layer_norm_grad", {}), ("reshape2", {}), ("adam", {}),
    ("layer_norm", {"__amp__": "bf16"}), ("mul", {"__amp__": "f32"}),
    ("mul", {"__amp__": "keep"})])
def test_amp_cast_matches_jax(op_type, attrs):
    rs = np.random.RandomState(0)
    f32 = (rs.randn(3, 5) * 10).astype("float32")
    f2 = (rs.randn(4) * 1e3).astype("float32")
    ids = rs.randint(0, 9, (2, 3)).astype("int32")
    jins = {"X": [jnp.asarray(f32), None],
            "Y": [jnp.asarray(f2).astype(jnp.bfloat16)],
            "Ids": [jnp.asarray(ids)]}
    tins = {"X": [torch.from_numpy(f32), None],
            "Y": [torch.from_numpy(f2).to(torch.bfloat16)],
            "Ids": [torch.from_numpy(ids)]}
    for jout, tout in ((jamp.amp_cast(op_type, attrs, jins),
                        tamp.amp_cast(op_type, attrs, tins)),
                       (jamp.apply_amp_policy(op_type, jins),
                        tamp.apply_amp_policy(op_type, tins))):
        assert sorted(jout) == sorted(tout)
        for slot in jout:
            for j, t in zip(jout[slot], tout[slot]):
                if j is None:
                    assert t is None
                    continue
                assert _dtype(t) == _dtype(j), (op_type, slot)
                np.testing.assert_array_equal(_np(t), _np(j))


def test_bf16_fetches_come_back_as_the_jax_packages_do():
    v = np.array([1.0, -2.5, 3e-3, 1e30], "float32")
    want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
    got = to_numpy(torch.from_numpy(v).to(torch.bfloat16))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


# ------------------------------------------- tests/test_amp.py, the port
def _mlp_program(pkg, amp, lr=1e-2):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[32], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=64, act="relu")
        logits = pkg.layers.fc(h, size=10)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        opt = pkg.optimizer.Adam(learning_rate=lr)
        if amp:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, logits, params_grads


def _mlp_data(n=128):
    rs = np.random.RandomState(0)
    x = rs.rand(n, 32).astype("float32")
    return {"x": x, "y": (x.sum(1) * 3 % 10).astype("int64").reshape(-1, 1)}


def _train(main, startup, loss, scope, steps=40):
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _mlp_data()
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].reshape(()))
            for _ in range(steps)]


class TestPortAmp:
    def test_converges_and_masters_stay_f32(self):
        main, startup, loss, _, _ = _mlp_program(pt, amp=True)
        scope = pt.Scope()
        losses = _train(main, startup, loss, scope)
        assert losses[-1] < 0.5 * losses[0]
        for p in main.global_block().all_parameters():
            assert scope.find_var(p.name).dtype == torch.float32, p.name

    def test_matches_f32_training(self):
        main, startup, loss, _, _ = _mlp_program(pt, amp=False)
        ref = _train(main, startup, loss, pt.Scope())
        main2, startup2, loss2, _, _ = _mlp_program(pt, amp=True)
        got = _train(main2, startup2, loss2, pt.Scope())
        # same trajectory within bf16 tolerance (first step near-exact)
        assert abs(got[0] - ref[0]) < 2e-2
        assert abs(got[-1] - ref[-1]) < 0.3

    def test_program_version_bumps_and_clone_carries_amp(self):
        p = pt.Program()
        v0 = p.version
        p.set_amp(True)
        assert p.version == v0 + 1 and p.amp
        p.set_amp(True)  # idempotent: no extra re-prepare
        assert p.version == v0 + 1
        assert p.clone().amp is True

    def test_decorate_passthrough_attrs(self):
        opt = pt.contrib.mixed_precision.decorate(
            pt.optimizer.SGD(learning_rate=0.1), init_loss_scaling=128.0)
        assert opt.loss_scaling == 128.0
        assert opt._lr == 0.1  # delegated


def test_set_amp_reprepares_the_plan():
    """The plan cache keys on the program's version, which ``set_amp``
    bumps: the same executor then runs the program under the policy."""
    main, startup, _, logits, _ = _mlp_program(pt, amp=False)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _mlp_data(4)
    run = lambda: exe.run(main, feed=feed, fetch_list=[logits],  # noqa
                          scope=scope, return_numpy=False)[0]
    assert run().dtype == torch.float32
    main.set_amp(True)
    assert run().dtype == torch.bfloat16
    main.set_amp(False)
    assert run().dtype == torch.float32


# --------------------------------------------------------- MLP parity
@pytest.mark.parametrize("level", ["0", "2"])
def test_mlp_amp_matches_jax(level, monkeypatch):
    """C4: at level 2 the parent failed at prepare (no core/amp.py); at
    level 0 it computed in f32 and fetched f32 logits and grads."""
    jmain, jstart, jloss, jlogits, jpg = _mlp_program(jf, True)
    tmain, _, tloss, tlogits, tpg = _mlp_program(pt, True)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    feed = _mlp_data(16)
    jfetch = [jloss, jlogits] + [g for _, g in jpg]
    jfirst = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=jscope)
    jlosses = [float(np.asarray(jfirst[0]).reshape(()))] + [
        float(np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jloss],
                                  scope=jscope)[0]).reshape(()))
        for _ in range(2)]

    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", level)
    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        tscope.set_var(n, v)
    tfetch = [tloss, tlogits] + [g for _, g in tpg]
    tfirst = texe.run(tmain, feed=feed, fetch_list=tfetch, scope=tscope,
                      return_numpy=False)
    tlosses = [float(tfirst[0].reshape(()))] + [
        float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                       scope=tscope)[0].reshape(())) for _ in range(2)]
    assert [_dtype(v) for v in tfirst] == [_dtype(v) for v in jfirst]
    assert _dtype(tfirst[1]) == "bfloat16" and _dtype(tfirst[0]) == \
        "float32"
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-2)
    for p in tmain.global_block().all_parameters():
        np.testing.assert_allclose(
            tscope.find_var(p.name).numpy(),
            np.asarray(jscope.find_var(p.name)), atol=2e-3, rtol=0,
            err_msg=p.name)


# -------------------------------------------------------- BERT parity
CFG = dict(d_model=64, d_ff=128, n_head=2, n_layer=2, vocab=100,
           type_vocab=2, max_length=32, dropout=0.0)
S, M, B = 32, 6, 3
BERT_LR = 1e-3


def _bert_program(pkg, bert_mod):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = bert_mod.build(CFG, seq_len=S, max_mask=M)
        opt = pkg.contrib.mixed_precision.decorate(
            pkg.optimizer.Adam(learning_rate=BERT_LR))
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, params_grads


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


@pytest.fixture(scope="module")
def bert_jax():
    """The JAX package under AMP, composed attention: its post-startup
    scope; the first step's loss and grads from its lowerings run op by
    op; 3 Adam steps through its Executor (losses, final params)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_FLASH_MIN_SEQ", NO_FLASH)
        main, startup, loss, params_grads = _bert_program(jf, jbert)
        exe, scope = jf.Executor(jf.CPUPlace()), jf.Scope()
        exe.run(startup, scope=scope)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
        feeds = _bert_feeds(3)
        env = {k: jnp.asarray(v) for k, v in state.items()}
        env.update({k: jnp.asarray(v.astype("int32") if v.dtype == np.int64
                                   else v) for k, v in feeds[0].items()})
        block = main.global_block()
        with jax.disable_jit():
            jax_lower_block(JaxContext(block, jax.random.PRNGKey(0),
                                       amp=True), block, env)
        first = dict(loss=float(np.asarray(env[loss.name]).reshape(())),
                     grads={p.name: env[g.name] for p, g in params_grads})
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]).reshape(()))
                  for f in feeds]
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p, _ in params_grads}
    return dict(state=state, feeds=feeds, first=first, losses=losses,
                params=params)


def _port_bert(bert_jax):
    main, _, loss, params_grads = _bert_program(pt, tbert)
    scope = pt.Scope()
    for n, v in params_from_jax(bert_jax["state"], main, CPU).items():
        scope.set_var(n, v)
    return main, loss, params_grads, scope


def test_bert_amp_first_step_matches_jax_op_by_op(bert_jax, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", NO_FLASH)
    main, loss, params_grads, scope = _port_bert(bert_jax)
    out = pt.Executor(pt.CPUPlace()).run(
        main, feed=bert_jax["feeds"][0],
        fetch_list=[loss] + [g for _, g in params_grads], scope=scope,
        return_numpy=False)
    want = bert_jax["first"]
    np.testing.assert_allclose(float(out[0].reshape(())), want["loss"],
                               rtol=1e-2)
    bf16 = 0
    for (p, _), g in zip(params_grads, out[1:]):
        jg = want["grads"][p.name]
        assert _dtype(g) == _dtype(jg), p.name
        bf16 += _dtype(g) == "bfloat16"
        assert _l2_rel(_np(g), _np(jg)) <= 3e-2, p.name
    # every grad is bf16 but the layer norms' scale and bias
    n_ln = sum("layer_norm" in p.name or "_ln_" in p.name
               for p, _ in params_grads)
    assert bf16 == len(params_grads) - n_ln and n_ln > 0


def test_bert_amp_trains_like_jax(bert_jax, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", NO_FLASH)
    main, loss, params_grads, scope = _port_bert(bert_jax)
    exe = pt.Executor(pt.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(()))
              for f in bert_jax["feeds"]]
    np.testing.assert_allclose(losses, bert_jax["losses"], rtol=1e-2)
    for name, want in bert_jax["params"].items():
        got = scope.find_var(name)
        assert got.dtype == torch.float32
        start = bert_jax["state"][name]
        assert _l2_rel(got.numpy() - start, want - start) <= 0.3, name


def test_bert_amp_level2_is_bitwise_level0(bert_jax, monkeypatch):
    runs = []
    for level in ("2", "0"):
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZE", level)
        main, loss, params_grads, scope = _port_bert(bert_jax)
        exe = pt.Executor(pt.CPUPlace())
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in bert_jax["feeds"]]
        runs.append((losses, {p.name: scope.find_var(p.name)
                              for p, _ in params_grads}))
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    for name, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][name]), name


# ------------------------------------------------------------ fused ops
def _ln_inputs(x_dtype, r_dtype, n=37, d=96, seed=3):
    rs = np.random.RandomState(seed)
    x, r = (rs.randn(n, d).astype("float32") for _ in range(2))
    sc = (1 + 0.1 * rs.randn(d)).astype("float32")
    b = (0.1 * rs.randn(d)).astype("float32")
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    port = [torch.from_numpy(x).to(tdt[x_dtype]),
            torch.from_numpy(r).to(tdt[r_dtype]), torch.from_numpy(sc),
            torch.from_numpy(b)]
    jax_ = [jnp.asarray(x).astype(jdt[x_dtype]),
            jnp.asarray(r).astype(jdt[r_dtype]), jnp.asarray(sc),
            jnp.asarray(b)]
    return port, jax_


LN_ATTRS = {"add_attrs": {"axis": -1},
            "ln_attrs": {"epsilon": 1e-5, "begin_norm_axis": 1}}
DTYPE_PAIRS = [("bfloat16", "bfloat16"), ("float32", "bfloat16"),
               ("bfloat16", "float32")]


@pytest.mark.parametrize("x_dtype,r_dtype", DTYPE_PAIRS)
def test_fused_layernorm_residual_replays_the_amp_pair(x_dtype, r_dtype):
    (x, r, sc, b), _ = _ln_inputs(x_dtype, r_dtype)
    ctx = LowerContext(None, None, CPU, amp=True)
    got = get_op("fused_layernorm_residual").lowering(
        ctx, {"X": [x], "Residual": [r], "Scale": [sc], "Bias": [b]},
        LN_ATTRS)
    add_ins = tamp.amp_cast("elementwise_add", {}, {"X": [x], "Y": [r]})
    s = get_op("elementwise_add").lowering(ctx, add_ins, {"axis": -1})
    s = s["Out"][0]
    ln_ins = tamp.amp_cast("layer_norm", {}, {"X": [s], "Scale": [sc],
                                              "Bias": [b]})
    want = get_op("layer_norm").lowering(ctx, ln_ins, LN_ATTRS["ln_attrs"])
    assert got["ResOut"][0].dtype == torch.bfloat16
    assert got["Y"][0].dtype == torch.float32
    assert torch.equal(got["ResOut"][0], s)
    for slot in ("Y", "Mean", "Variance"):
        assert torch.equal(got[slot][0], want[slot][0]), slot


@pytest.mark.parametrize("x_dtype,r_dtype", DTYPE_PAIRS)
def test_k4_amp_plain_version_matches_jax_fused_op(x_dtype, r_dtype):
    (x, r, sc, b), (jx, jr, jsc, jb) = _ln_inputs(x_dtype, r_dtype)
    want = jax_op("fused_layernorm_residual").lowering(
        JaxContext(None, None, amp=True),
        {"X": [jx], "Residual": [jr], "Scale": [jsc], "Bias": [jb]},
        LN_ATTRS)
    y, s, mean, var = tln.layernorm_residual_fwd_amp(x, r, sc, b, 1e-5)
    assert _dtype(s) == _dtype(want["ResOut"][0]) == "bfloat16"
    assert _dtype(y) == _dtype(want["Y"][0]) == "float32"
    np.testing.assert_array_equal(_np(s), _np(want["ResOut"][0]))
    for got, slot in ((y, "Y"), (mean, "Mean"), (var, "Variance")):
        np.testing.assert_allclose(_np(got).reshape(-1),
                                   _np(want[slot][0]).reshape(-1),
                                   atol=1e-5, rtol=0, err_msg=slot)


def _opt_group(kind, seed=4):
    """A fused optimizer group over mixed grads (bf16 as a mul's, f32 as
    a layer norm's) in both packages' types."""
    rs = np.random.RandomState(seed)
    shapes = [(5, 7), (7,), (33,), (2, 3, 4)]
    bf16 = [True, False, True, False]
    mk = lambda s, a=1.0: (rs.rand(*s) * a + 0.05).astype("float32")  # noqa
    vals = {"Param": [mk(s) for s in shapes],
            "Grad": [mk(s) - 0.5 for s in shapes],
            "Moment1": [mk(s, 0.1) for s in shapes],
            "Moment2": [mk(s, 0.01) for s in shapes],
            "Beta1Pow": [np.full((1,), 0.9 ** 2, "float32")] * 4,
            "Beta2Pow": [np.full((1,), 0.999 ** 2, "float32")] * 4,
            "LearningRate": [np.full((1,), 1e-2, "float32")] * 4}
    slots = topt.OPT_IN_SLOTS[kind]
    tins = {s: [torch.from_numpy(v) for v in vals[s]] for s in slots}
    jins = {s: [jnp.asarray(v) for v in vals[s]] for s in slots}
    tins["Grad"] = [g.to(torch.bfloat16) if bf else g
                    for g, bf in zip(tins["Grad"], bf16)]
    jins["Grad"] = [g.astype(jnp.bfloat16) if bf else g
                    for g, bf in zip(jins["Grad"], bf16)]
    return tins, jins


@pytest.mark.parametrize("kind", ["adam", "sgd"])
@pytest.mark.parametrize("override", [None, "f32"])
def test_fused_optimizer_update_amp_matches_jax(kind, override):
    tins, jins = _opt_group(kind)
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8} \
        if kind == "adam" else {}
    attrs = {"kind": kind, "hyper": hyper}
    if override:
        attrs["amp_override"] = override
    want = jax_op("fused_optimizer_update").lowering(
        JaxContext(None, None, amp=True), jins, attrs)
    got = get_op("fused_optimizer_update").lowering(
        LowerContext(None, None, CPU, amp=True), tins, attrs)
    plain = (topt.adam_group_reference(tins, hyper) if kind == "adam"
             else topt.sgd_group_reference(tins))
    for slot in topt.OPT_OUT_SLOTS[kind]:
        for g, p, w in zip(got[slot], plain[slot], want[slot]):
            assert _dtype(g) == _dtype(w) == "float32"
            np.testing.assert_allclose(_np(g), _np(w), atol=2e-6, rtol=0)
            np.testing.assert_allclose(_np(p), _np(w), atol=2e-6, rtol=0)


# ------------------------------------------------- passes, lint, serving
@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_pipeline_under_amp_matches_jax_on_bert_mlm(opt):
    programs = []
    for pkg, mod in ((jf, jbert), (pt, tbert)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss, _ = mod.build(CFG, seq_len=S, max_mask=M)
            pkg.contrib.mixed_precision.decorate(
                getattr(pkg.optimizer, opt)(learning_rate=1e-3)).minimize(
                    loss)
        programs.append((main, loss))
    (jmain, jloss), (tmain, tloss) = programs
    jo, jstats = jax_optimize(jmain, fetch_list=[jloss])
    to, tstats = optimize_program(tmain, fetch_list=[tloss])
    assert to.amp and to.to_dict() == jo.to_dict()
    strip = lambda st: [{k: v for k, v in r.items() if k != "seconds"}  # noqa
                        for r in st]
    assert strip(tstats) == strip(jstats)
    rows = {r["pass"]: r for r in tstats}
    assert rows["amp_bf16_pass"]["amp_tagged"] > 0
    assert rows["constant_folding_pass"]["folded"] > 0


def _const_chain(pkg):
    """A constant chain through bf16-class ops (scale, elementwise_mul)
    and an f32 one (exp): folded under AMP, its values are the casts'."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4])
        c = pkg.layers.fill_constant([4], "float32", 0.3)
        d = pkg.layers.scale(c, scale=3.7, bias=0.11)
        e = pkg.layers.elementwise_mul(d, pkg.layers.exp(c))
        out = pkg.layers.elementwise_add(x, e)
    main.set_amp(True)
    return main, out


def test_fold_under_amp_folds_what_jax_folds():
    jmain, jout = _const_chain(jf)
    tmain, tout = _const_chain(pt)
    jo, jstats = jax_optimize(jmain, fetch_list=[jout], level=1)
    to, tstats = optimize_program(tmain, fetch_list=[tout], level=1)
    assert to.to_dict() == jo.to_dict()
    folds = [op for op in to.global_block().ops if op.type == "assign_value"]
    assert [op.attrs["dtype"] for op in folds] == ["bfloat16"]
    (fold_row,) = [r for r in tstats if r["pass"] == "constant_folding_pass"]
    assert fold_row["folded"] == 4
    # the folded program computes what the unfolded one does under AMP
    feed = {"x": np.arange(8, dtype="float32").reshape(2, 4)}
    exe = pt.Executor(pt.CPUPlace())
    got = exe.run(tmain, feed=feed, fetch_list=[tout], scope=pt.Scope(),
                  return_numpy=False)[0]
    tmain.exact_numerics = True  # the unoptimized program
    want = exe.run(tmain, feed=feed, fetch_list=[tout], scope=pt.Scope(),
                   return_numpy=False)[0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _overflow_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        big = pkg.layers.fill_constant([4], "float32", 3.395e38)
        pkg.layers.elementwise_mul(pkg.layers.sigmoid(x), big)
    return main


def test_lint_amp_rule_fires_where_jax_does():
    found = []
    for pkg, lint in ((jf, jax_lint), (pt, lint_program)):
        main = _overflow_program(pkg)
        assert [f for f in lint(main) if f.rule == "bf16-overflow"] == []
        main.set_amp(True)
        found.append([(f.rule, f.severity, f.op_type)
                      for f in lint(main) if f.rule == "bf16-overflow"])
    assert found[1] == found[0] and len(found[1]) == 1


def test_amp_inference_model_serves_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", NO_FLASH)
    cfg = dict(CFG, n_layer=2)
    main, startup = jf.Program(), jf.Program()
    main.random_seed = startup.random_seed = 7
    with jf.program_guard(main, startup), jf.unique_name.guard():
        jbert.build(cfg, seq_len=S, is_test=True)
    main.set_amp(True)
    blk = main.global_block()
    gather = next(op for op in blk.ops if op.type == "gather")
    enc = next(op for op in blk.ops if op.type == "reshape2" and
               gather.input("X")[0] in op.output("Out")).input("X")[0]
    exe, scope = jf.Executor(jf.CPUPlace()), jf.Scope()
    exe.run(startup, scope=scope)
    with jf.scope_guard(scope):
        jf.io.save_inference_model(
            str(tmp_path), ["src_ids", "sent_ids", "input_mask"],
            [blk.var(enc)], exe, main_program=main)
    feed = {k: v for k, v in _bert_feeds(1)[0].items()
            if k in ("src_ids", "sent_ids", "input_mask")}
    (want,) = jf.inference.create_paddle_predictor(
        jf.inference.AnalysisConfig(str(tmp_path))).run(feed)
    pred = pt.inference.create_paddle_predictor(
        pt.inference.AnalysisConfig(str(tmp_path)).disable_gpu())
    assert pred.program.amp
    (got,) = pred.run(feed)
    assert got.dtype == np.asarray(want).dtype == np.float32
    assert _l2_rel(got, np.asarray(want)) <= 2e-2


# ------------------------------------------------ the kernels' route
def test_k6_k7_bf16_grad_alignment_classification():
    """A bf16 grad streams 8 bytes a vector: its entry takes the vector
    path at an 8-byte aligned address; the table marks its dtype."""
    base = 1 << 20
    cols = {s: [base + 64 * i for i in range(3)]
            for s in topt.ADAM_FIELDS[:12]}
    cols["Grad"] = [base + 8, base + 72, base + 130]
    bf16 = [True, False, True]
    assert topt.vector_entries("adam", cols, bf16).tolist() == [
        True, False, False]
    rows, tiles, vec = topt.table_rows("adam", cols, [5000, 1, 2048], bf16)
    assert (tiles, vec) == (5, 1)
    assert rows[:, topt.ADAM_FIELDS.index("grad_bf16")].tolist() == [1, 0, 1]
    sgd = {s: [base, base + 32] for s in topt.SGD_FIELDS[:4]}
    sgd["Grad"] = [base + 8, base + 8]
    assert topt.vector_entries("sgd", sgd, [True, False]).tolist() == [
        True, False]


def test_k6_k7_take_bf16_grads_and_nothing_else_new():
    tins, _ = _opt_group("adam")
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    topt.adam_group(tins, hyper)  # bf16 and f32 grads: accepted
    for slot in ("Param", "Moment1", "LearningRate"):
        bad = dict(tins, **{slot: [t.to(torch.bfloat16) for t in
                                   tins[slot]]})
        with pytest.raises(ValueError, match="dtype"):
            topt.adam_group(bad, hyper)
    bad = dict(tins, Grad=[t.to(torch.float16) for t in tins["Grad"]])
    with pytest.raises(ValueError, match="dtype"):
        topt.sgd_group(bad)


def test_amp_step_routes_to_the_amp_kernels(bert_jax, monkeypatch):
    """With the kernel route forced on the CPU (where each wrapper
    computes its plain version), an AMP step at level 2 sends every
    fused layer norm to K4's AMP instantiation and the optimizer group
    to K6 with the bf16 grads as they come (no cast), and takes the
    replay's step within two ulps of the bf16 loss."""
    from paddle_tpu_torch.ops import fused_ops

    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", NO_FLASH)
    calls = {"k4_amp": 0, "k4": 0, "k6_grads": []}
    amp_fwd, fwd, adam = (tln.layernorm_residual_fwd_amp,
                          tln.layernorm_residual_fwd, topt.adam_group)

    def spy_amp(*a):
        calls["k4_amp"] += 1
        return amp_fwd(*a)

    def spy_fwd(*a):
        calls["k4"] += 1
        return fwd(*a)

    def spy_adam(ins, hyper):
        calls["k6_grads"].append([g.dtype for g in ins["Grad"]])
        return adam(ins, hyper)

    main, loss, params_grads, scope = _port_bert(bert_jax)
    feed = bert_jax["feeds"][0]
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                          fetch_list=[loss], scope=scope)
    monkeypatch.setattr(fused_ops, "_on_card", lambda t: True)
    monkeypatch.setattr(tln, "layernorm_residual_fwd_amp", spy_amp)
    monkeypatch.setattr(tln, "layernorm_residual_fwd", spy_fwd)
    monkeypatch.setattr(topt, "adam_group", spy_adam)
    main, loss, params_grads, scope = _port_bert(bert_jax)
    got = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[loss],
                                         scope=scope)
    assert calls["k4_amp"] == 2 * CFG["n_layer"] + 1 and calls["k4"] == 0
    (dtypes,) = calls["k6_grads"]
    n_bf16 = sum(d == torch.bfloat16 for d in dtypes)
    assert 0 < n_bf16 < len(dtypes) == len(params_grads)
    np.testing.assert_allclose(np.asarray(got[0]).reshape(()),
                               np.asarray(want[0]).reshape(()),
                               rtol=2 ** -6)


def test_fused_layernorm_residual_kernel_per_amp_classes(monkeypatch):
    """On the card, the fused pair takes the instantiation its classes
    compute: the AMP one for the policy's bf16 add and f32 layer norm,
    K4 at f32 for an add stamped f32 (the range-aware pass), and no
    kernel (it raises) for a pair no instantiation computes."""
    from paddle_tpu_torch.ops import fused_ops

    monkeypatch.setattr(fused_ops, "_on_card", lambda t: True)
    (x, r, sc, b), _ = _ln_inputs("bfloat16", "float32")
    ins = {"X": [x], "Residual": [r], "Scale": [sc], "Bias": [b]}
    ctx = LowerContext(None, None, CPU, amp=True)
    run = lambda attrs: get_op("fused_layernorm_residual").lowering(  # noqa
        ctx, ins, attrs)
    out = run(LN_ATTRS)
    assert (out["ResOut"][0].dtype, out["Y"][0].dtype) == (torch.bfloat16,
                                                           torch.float32)
    y, s, _, _ = tln.composed_layernorm_residual(x, r, sc, b, eps=1e-5,
                                                 amp=True)
    assert torch.equal(out["ResOut"][0], s) and torch.equal(out["Y"][0], y)
    kept = {"add_attrs": dict(LN_ATTRS["add_attrs"], __amp__="f32"),
            "ln_attrs": dict(LN_ATTRS["ln_attrs"], __amp__="f32")}
    out = run(kept)
    assert (out["ResOut"][0].dtype, out["Y"][0].dtype) == (torch.float32,
                                                           torch.float32)
    y, s, _, _ = tln.composed_layernorm_residual(x.float(), r, sc, b,
                                                 eps=1e-5)
    assert torch.equal(out["ResOut"][0], s) and torch.equal(out["Y"][0], y)
    with pytest.raises(NotImplementedError, match="no kernel"):
        run({"add_attrs": LN_ATTRS["add_attrs"],
             "ln_attrs": dict(LN_ATTRS["ln_attrs"], __amp__="bf16")})
