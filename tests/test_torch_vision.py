"""The image-classification slice in the port against the JAX package on
the CPU: the six zoo models whose ops it opens (the MNIST CNN, ResNet-50,
VGG-16, SE-ResNeXt-50, a small ViT and DeepFM CTR, at
tools/lint_program.py's example sizes), the edges of their ops and
their AMP casts, serving a ResNet through the Predictor, and the copies
of ``metrics.py`` and ``evaluator.py``.

Models: both packages build the same Program (``to_dict``) with
``Adam.minimize`` (lr 1e-3); the JAX startup scope moves into the port
with ``params_from_jax`` (the batch norms' running mean and variance
too: persistables, not params). VGG and SE-ResNeXt always build
dropout: each dropout op is set to ``is_test`` in both programs before
running, as the Predictor does, so no random mask enters the
comparison. ViT runs without dropout and, at S = 17, through the flash
kernels' plain versions in the port (the JAX package's Pallas kernels in
interpret mode: PADDLE_TPU_FLASH_MIN_SEQ is 0 in conftest).

- The MNIST CNN, DeepFM and ViT take 5 steps in each package on the same
  numpy feeds: losses agree to a relative 1e-5 and params to atol 1e-4,
  the transformer test's tolerances (tests/test_torch_training.py says
  why 1e-4: Adam moves a param whose grad is rounding noise by up to
  lr), and ``accuracy`` exactly.
- ResNet-50, VGG-16 and SE-ResNeXt-50 train chaotically at these sizes
  in the JAX package itself: tests/test_torch_vision_bn.py holds them
  step by step and says why.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import OPS, get_op

CPU = torch.device("cpu")
LR, STEPS = 1e-3, 5
VIT_CFG = dict(image_size=32, patch=8, d_model=64, d_ff=128, n_head=4,
               n_layer=2, n_class=10, dropout=0.0)


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


def _image_feeds(rs, batch, shape, classes):
    return {"img": rs.randn(batch, *shape).astype("float32"),
            "label": rs.randint(0, classes, (batch, 1)).astype("int64")}


def _ctr_feeds(rs, batch):
    return {"sparse_ids": rs.randint(0, 1000, (batch, 26)).astype("int64"),
            "dense": rs.rand(batch, 13).astype("float32"),
            "label": rs.randint(0, 2, (batch, 1)).astype("int64")}


# name -> (build(models module of a package) -> (loss, acc), feeds(rs))
MODELS = {
    "mnist": (lambda m: m.mnist.build("cnn")[:2],
              lambda rs: {"img": rs.rand(4, 784).astype("float32"),
                          "label": rs.randint(0, 10, (4, 1)).astype(
                              "int64")}),
    "resnet": (lambda m: m.resnet.build(class_dim=10, depth=50,
                                        image_shape=(3, 32, 32))[:2],
               lambda rs: _image_feeds(rs, 2, (3, 32, 32), 10)),
    "vgg": (lambda m: m.vgg.build(class_dim=10, image_shape=(3, 32, 32))[:2],
            lambda rs: _image_feeds(rs, 2, (3, 32, 32), 10)),
    "se_resnext": (lambda m: m.se_resnext.build(
        class_dim=10, image_shape=(3, 32, 32))[:2],
        lambda rs: _image_feeds(rs, 2, (3, 32, 32), 10)),
    "vit": (lambda m: m.vit.build(dict(VIT_CFG)),
            lambda rs: _image_feeds(rs, 3, (3, 32, 32), 10)),
    "ctr": (lambda m: m.ctr.build("deepfm", vocab=1000, emb_dim=8)[:2],
            lambda rs: _ctr_feeds(rs, 8)),
}


def _build(pkg, name):
    from importlib import import_module

    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, acc = MODELS[name][0](import_module(pkg.__name__ + ".models"))
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    # dropout in test mode in both programs (the Predictor's rewrite)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["is_test"] = True
    main._bump()
    return main, startup, loss, acc


def test_every_op_of_the_image_and_ctr_models_lowers_in_the_port():
    """Every op type of the six models' training and startup programs
    (tools/lint_program.py's examples, with Adam) has a lowering in the
    port; their grad ops are synthesized from those lowerings."""
    for name in MODELS:
        main, startup, _, _ = _build(pt, name)
        types = {op.type for p in (main, startup)
                 for op in p.global_block().ops}
        missing = sorted(t for t in types if t not in OPS and not (
            t.endswith("_grad") and t[:-len("_grad")] in OPS))
        assert missing == [], (name, missing)
    for t in ("conv2d", "pool2d", "batch_norm", "gaussian_random",
              "cross_entropy", "top_k", "accuracy", "auc",
              "precision_recall"):
        assert t in OPS, t


def test_every_op_of_every_zoo_model_lowers_in_the_port():
    """All eleven of tools/lint_program.py's ``build_example`` models
    (with Adam): every op type of every block of the training and
    startup programs has a lowering in the port (sub-blocks included:
    a DynamicRNN step, a While body). The sequence models build the same
    Program in the port as in the JAX package."""
    import os
    import sys
    from importlib import import_module

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from lint_program import EXAMPLE_BUILDERS, build_example

    assert len(EXAMPLE_BUILDERS) == 11
    for name in sorted(EXAMPLE_BUILDERS):
        main, startup, _ = build_example(name)
        types = {op.type for p in (main, startup) for b in p.blocks
                 for op in b.ops}
        missing = sorted(t for t in types if t not in OPS and not (
            t.endswith("_grad") and t[:-len("_grad")] in OPS))
        assert missing == [], (name, missing)
    cfgs = {"stacked_lstm": dict(vocab=60, emb_dim=16, hidden=16,
                                 num_layers=2, num_classes=2, seq_len=10),
            "machine_translation": dict(src_vocab=50, trg_vocab=50,
                                        emb_dim=16, hidden=16, seq_len=8)}
    for name, cfg in cfgs.items():
        progs = []
        for pkg in (jf, pt):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup), pkg.unique_name.guard():
                loss = import_module(pkg.__name__ + ".models." + name).build(
                    cfg)[0]
                pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
            progs.append((main.to_dict(), startup.to_dict()))
        assert progs[0] == progs[1], name


def _bn_stats(program):
    """The batch norms' running mean and variance var names."""
    return sorted(n for op in program.global_block().ops
                  if op.type == "batch_norm"
                  for n in op.input("Mean") + op.input("Variance"))


FREE_RUNNING = ("ctr", "mnist", "vit")


@pytest.mark.parametrize("name", FREE_RUNNING)
def test_model_trains_like_the_jax_package(name):
    jmain, jstart, jloss, jacc = _build(jf, name)
    tmain, tstart, tloss, tacc = _build(pt, name)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    rs = np.random.RandomState(3)
    feeds = [MODELS[name][1](rs) for _ in range(STEPS)]

    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    want = [[np.asarray(v) for v in jexe.run(
        jmain, feed=f, fetch_list=[jloss, jacc], scope=jscope)]
        for f in feeds]

    scope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        scope.set_var(n, v)
    exe = pt.Executor(pt.CPUPlace())
    got = [exe.run(tmain, feed=f, fetch_list=[tloss, tacc], scope=scope)
           for f in feeds]
    np.testing.assert_allclose([float(g[0].reshape(())) for g in got],
                               [float(w[0].reshape(())) for w in want],
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(np.stack([g[1] for g in got]),
                                  np.stack([w[1] for w in want]))
    for p in tmain.global_block().all_parameters():
        np.testing.assert_allclose(scope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   atol=1e-4, rtol=0, err_msg=p.name)
    assert not _bn_stats(tmain)


def test_params_from_jax_carries_the_batch_norm_running_stats():
    """The running mean and variance are persistables, not params:
    ``params_from_jax`` moves them with the params, and refuses a scope
    that lacks them."""
    main, _, _, _ = _build(pt, "resnet")
    stats = _bn_stats(main)
    params = {p.name for p in main.global_block().all_parameters()}
    assert len(stats) == 2 * 53 and not set(stats) & params
    state = {v.name: np.full(v.shape, 0.25 + i, "float32")
             for i, v in enumerate(main.list_vars()) if v.persistable}
    out = params_from_jax(state, main, CPU)
    for n in stats:
        np.testing.assert_array_equal(out[n].numpy(), state[n])
    state.pop(stats[0])
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(state, main, CPU)


# ------------------------------------------------------------ op edges
def _jax_vjp(op_type, ins, attrs, slot, diff, cot, pre=None):
    def f(*vals):
        merged = dict(ins)
        for (s, _), v in zip(diff, vals):
            merged = dict(merged, **{s: [v]})
        if pre is not None:
            merged = pre(merged)
        return jax_op(op_type).lowering(JaxContext(None, None), merged,
                                        dict(attrs))[slot][0]

    prim = [jnp.asarray(ins[s][0]) for s, _ in diff]
    out, vjp = jax.vjp(f, *prim)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_vjp(op_type, ins, attrs, slot, diff, cot, pre=None):
    ctx = LowerContext(None, None, CPU)

    def f(*vals):
        merged = dict(ins)
        for (s, _), v in zip(diff, vals):
            merged = dict(merged, **{s: [v]})
        if pre is not None:
            merged = pre(merged)
        return get_op(op_type).lowering(ctx, merged, dict(attrs))[slot][0]

    prim = [ins[s][0] for s, _ in diff]
    out, vjp = torch.func.vjp(f, *prim)
    return out.detach().numpy(), [g.numpy() for g in vjp(
        torch.from_numpy(cot))]


def _relu_jax(ins):
    return {"X": [jax_op("relu").lowering(None, ins, {})["Out"][0]]}


def _relu_port(ins):
    return {"X": [get_op("relu").lowering(None, ins, {})["Out"][0]]}


@pytest.mark.parametrize("after_relu", [True, False],
                         ids=["after_relu", "plain"])
def test_max_pool_routes_ties_as_the_jax_package(after_relu):
    """ResNet's 3x3/2 max pool (pad 1) on inputs full of ties: small
    integers, and after a relu every negative becomes a tie at 0. Both
    packages route a window's grad to its first largest element, so the
    grads agree exactly. After a relu the routing could not matter
    anyway: a tie at 0 lies where the relu's grad is 0 for every
    candidate (its pre-activation is negative, or exactly 0, where both
    packages' relu grad is 0 too), so whichever candidate a package
    picks, the input grad there is 0."""
    rs = np.random.RandomState(5)
    x = (rs.randint(-3, 3, (2, 4, 9, 9))).astype("float32")
    attrs = {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1]}
    cot = rs.randn(2, 4, 5, 5).astype("float32")
    pre = (_relu_jax, _relu_port) if after_relu else (None, None)
    jout, (jg,) = _jax_vjp("pool2d", {"X": [x]}, attrs, "Out", [("X", 0)],
                           cot, pre[0])
    tout, (tg,) = _port_vjp("pool2d", {"X": [torch.from_numpy(x)]}, attrs,
                            "Out", [("X", 0)], cot, pre[1])
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tg, jg)
    # the windows overlap and tie: a grad lands only on a window's max
    assert (tg != 0).sum() < x.size // 3
    if after_relu:
        assert not tg[x <= 0].any()


@pytest.mark.parametrize("case", ["train", "test", "nhwc", "global_stats"])
def test_batch_norm_stats_and_grads_match(case):
    """``batch_norm``'s every output and its grads against the JAX
    package: the biased batch variance, the running stats' update, the
    saved stats (the batch's mean and variance), the running stats in
    test mode, the channel axis last under NHWC."""
    rs = np.random.RandomState(6)
    attrs = {"train": {"momentum": 0.8}, "test": {"is_test": True},
             "nhwc": {"data_layout": "NHWC"},
             "global_stats": {"use_global_stats": True}}[case]
    c = 3
    x = (rs.randn(4, c, 5, 6) * 2 + 1).astype("float32")
    if case == "nhwc":
        x = x.transpose(0, 2, 3, 1).copy()
    ins = {"X": [x], "Scale": [rs.randn(c).astype("float32")],
           "Bias": [rs.randn(c).astype("float32")],
           "Mean": [rs.randn(c).astype("float32")],
           "Variance": [(np.abs(rs.randn(c)) + 0.5).astype("float32")]}
    j = jax_op("batch_norm").lowering(
        JaxContext(None, None), {k: [jnp.asarray(v[0])] for k, v in
                                 ins.items()}, dict(attrs))
    t = get_op("batch_norm").lowering(
        LowerContext(None, None, CPU),
        {k: [torch.from_numpy(v[0])] for k, v in ins.items()}, dict(attrs))
    for slot in ("Y", "MeanOut", "VarianceOut", "SavedMean",
                 "SavedVariance"):
        np.testing.assert_allclose(t[slot][0].numpy(), np.asarray(j[slot][0]),
                                   atol=1e-5, rtol=0, err_msg=slot)
    axes = (0, 1, 2) if case == "nhwc" else (0, 2, 3)
    if case in ("train", "nhwc"):
        # ddof 0, and the saved stats are the batch's
        np.testing.assert_allclose(t["SavedVariance"][0].numpy(),
                                   x.var(axis=axes), rtol=1e-5)
        m = attrs.get("momentum", 0.9)
        np.testing.assert_allclose(
            t["MeanOut"][0].numpy(),
            ins["Mean"][0] * m + x.mean(axis=axes) * (1 - m), rtol=1e-5,
            atol=1e-6)
    else:
        np.testing.assert_array_equal(t["MeanOut"][0].numpy(),
                                      ins["Mean"][0])
    cot = rs.randn(*x.shape).astype("float32")
    diff = [("X", 0), ("Scale", 0), ("Bias", 0)]
    _, jg = _jax_vjp("batch_norm", ins, attrs, "Y", diff, cot)
    _, tg = _port_vjp("batch_norm", {k: [torch.from_numpy(v[0])] for k, v
                                     in ins.items()}, attrs, "Y", diff, cot)
    for (s, _), a, b in zip(diff, jg, tg):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=s)


def test_avg_pool_divides_as_the_jax_package():
    """Exclusive averaging divides by the real elements only when a pad
    is non-zero; without pads, or with ``exclusive`` off, by kh * kw,
    which is not ``F.avg_pool2d``'s ``count_include_pad`` rule at a
    border. ``ceil_mode`` changes nothing."""
    x = np.ones((1, 1, 5, 5), "float32")
    ctx = LowerContext(None, None, CPU)

    def pool(**attrs):
        base = {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2]}
        return get_op("pool2d").lowering(ctx, {"X": [torch.from_numpy(x)]},
                                         dict(base, **attrs))["Out"][0]

    excl = pool(paddings=[1, 1])
    assert torch.equal(excl, torch.ones_like(excl))  # real elements only
    incl = pool(paddings=[1, 1], exclusive=False)
    assert float(incl[0, 0, 0, 0]) == pytest.approx(4 / 9)
    assert torch.equal(pool(ceil_mode=True), pool())
    assert tuple(pool(paddings=[1, 1], ceil_mode=True).shape) == \
        (1, 1, 3, 3)


def test_top_k_puts_the_lower_index_first_on_ties():
    x = np.array([[1, 3, 3, 2, 3, 0], [5, 5, 5, 5, 5, 5]], "float32")
    out = get_op("top_k").lowering(LowerContext(None, None, CPU),
                                   {"X": [torch.from_numpy(x)]}, {"k": 4})
    np.testing.assert_array_equal(out["Indices"][0].numpy(),
                                  [[1, 2, 4, 3], [0, 1, 2, 3]])
    assert out["Indices"][0].dtype == torch.int32
    vals, idx = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(out["Indices"][0].numpy(), np.asarray(idx))


def test_amp_tables_cast_the_image_ops():
    """Under bf16 AMP ``lower_op`` casts each new op's inputs by the
    port's tables (the JAX package's): conv2d and pool2d compute bf16,
    batch_norm and cross_entropy f32 (their outputs show it)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.layers.data("img", [3, 8, 8])
        label = pt.layers.data("label", [1], dtype="int64")
        conv = pt.layers.conv2d(img, 4, 3, padding=1, bias_attr=False)
        bn = pt.layers.batch_norm(conv)
        pool = pt.layers.pool2d(bn, pool_size=2, pool_stride=2)
        probs = pt.layers.fc(pool, 5, act="softmax")
        loss = pt.layers.cross_entropy(probs, label)
    main.set_amp(True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(12)
    outs = exe.run(main, feed={"img": rs.randn(2, 3, 8, 8).astype("float32"),
                               "label": np.array([[1], [3]], "int64")},
                   fetch_list=[conv, bn, pool, loss], scope=scope,
                   return_numpy=False)
    assert [o.dtype for o in outs] == [torch.bfloat16, torch.float32,
                                       torch.bfloat16, torch.float32]


# ------------------------------------------------------------ serving
def test_resnet_served_by_the_predictor_like_the_jax_package(tmp_path):
    """A ResNet-50 inference program at 32 x 32 (10 classes) saved with
    ``save_inference_model`` in each package from one scope (its running
    stats moved by one forward in training mode), then each package's
    Predictor (batch norm rewritten to ``is_test``: the running stats)
    on the same images: answers within 1e-5."""
    def build(pkg):
        from importlib import import_module

        resnet = import_module(pkg.__name__ + ".models.resnet")
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 11
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            img = pkg.layers.data("img", [3, 32, 32])
            probs = resnet.resnet_imagenet(img, class_dim=10, depth=50)
        return main, startup, probs

    (jmain, jstart, jprobs), (tmain, _, tprobs) = build(jf), build(pt)
    assert tmain.to_dict() == jmain.to_dict()
    rs = np.random.RandomState(8)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    start = {n: np.asarray(jscope.find_var(n)) for n in _bn_stats(jmain)}
    jexe.run(jmain, feed=_image_feeds(rs, 4, (3, 32, 32), 10),
             fetch_list=[jprobs], scope=jscope)
    assert all(not np.array_equal(np.asarray(jscope.find_var(n)), v)
               for n, v in start.items())
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jf.scope_guard(jscope):
        jf.io.save_inference_model(jdir, ["img"], [jprobs], jexe,
                                   main_program=jmain)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    scope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        scope.set_var(n, v)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(tdir, ["img"], [tprobs],
                                   pt.Executor(pt.CPUPlace()),
                                   main_program=tmain)
    img = {"img": rs.randn(3, 3, 32, 32).astype("float32")}
    (want,) = jf.inference.create_paddle_predictor(
        jf.inference.AnalysisConfig(jdir)).run(img)
    pred = pt.inference.create_paddle_predictor(
        pt.inference.AnalysisConfig(tdir).disable_gpu())
    assert {op.attrs.get("is_test") for op in pred.program.global_block().ops
            if op.type == "batch_norm"} == {True}
    (got,) = pred.run(img)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    assert got.shape == (3, 10)


# ------------------------------------------------------------ the copies
def test_metrics_accumulators_match_the_jax_package():
    """``metrics.py`` (a copy) against the JAX package's on the same
    numpy batches: Accuracy, Auc, ChunkEvaluator, EditDistance and a
    CompositeMetric."""
    import paddle_tpu.metrics as jm
    import paddle_tpu_torch.metrics as tm

    rs = np.random.RandomState(9)
    results = []
    for m in (jm, tm):
        acc, auc, chunk = m.Accuracy(), m.Auc("auc"), m.ChunkEvaluator()
        ed = m.EditDistance("ed")
        comp = m.CompositeMetric()
        comp.add_metric(m.Accuracy())
        r = np.random.RandomState(9)
        for _ in range(4):
            acc.update(value=r.rand(), weight=r.randint(1, 9))
            auc.update(preds=r.rand(16, 2), labels=r.randint(0, 2, (16, 1)))
            chunk.update(*r.randint(1, 20, 3))
            ed.update(r.rand(5, 1), 5)
            comp.update(r.rand(), 4)
        results.append((acc.eval(), auc.eval(), chunk.eval(), ed.eval(),
                        comp.eval()))
    del rs
    for a, b in zip(*results):
        np.testing.assert_allclose(np.asarray(b, "float64").ravel(),
                                   np.asarray(a, "float64").ravel(),
                                   rtol=0, atol=0)


def _hits_evaluator(pkg, probs, label):
    """An evaluator on the copied base class: in-graph states summing
    ``accuracy``'s Correct and Total every run, read back by ``eval``."""

    class Hits(pkg.evaluator.Evaluator):
        def __init__(self):
            super().__init__("hits")
            acc = pkg.layers.accuracy(probs, label, k=2)
            op = probs.block.ops[-1]
            self.correct = self._create_state("correct", "float32")
            self.total = self._create_state("total", "float32")
            self._accumulate(self.correct, probs.block.var(
                op.output("Correct")[0]))
            self._accumulate(self.total, probs.block.var(
                op.output("Total")[0]))
            self.metrics = [acc]

        def eval(self, executor, eval_program=None, scope=None):
            return (float(self._state_value(self.correct, scope)[0])
                    / float(self._state_value(self.total, scope)[0]))

    return Hits()


def test_evaluator_matches_the_jax_package():
    """``evaluator.py`` (a copy): an evaluator on its base class sums
    ``accuracy``'s counts in persistable states over 3 batches of a small
    classifier, in both packages from one transplanted scope: the same
    value, and ``reset`` zeroes the states. ChunkEvaluator builds the
    same program in both (its ``chunk_eval`` op is not lowered in the
    port yet)."""
    rs = np.random.RandomState(10)
    feeds = [{"x": rs.randn(6, 5).astype("float32"),
              "label": rs.randint(0, 4, (6, 1)).astype("int64")}
             for _ in range(3)]

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [5])
            label = pkg.layers.data("label", [1], dtype="int64")
            probs = pkg.layers.fc(x, 4, act="softmax")
            ev = _hits_evaluator(pkg, probs, label)
        return main, startup, ev

    jmain, jstart, jev = build(jf)
    tmain, tstart, tev = build(pt)
    assert tmain.to_dict() == jmain.to_dict()
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    texe, tscope = pt.Executor(pt.CPUPlace()), pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        tscope.set_var(n, v)
    out = []
    for exe, scope, main, ev, mod in ((jexe, jscope, jmain, jev, jf),
                                      (texe, tscope, tmain, tev, pt)):
        with mod.scope_guard(scope):
            for f in feeds:
                exe.run(main, feed=f, fetch_list=ev.metrics, scope=scope)
            total = ev.eval(exe)
            ev.reset(exe)
            after = [np.asarray(scope.find_var(v.name)).copy()
                     for v in ev.states]
        out.append((total, after))
    assert out[1][0] == out[0][0] and 0 < out[0][0] < 1
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(b, a)
        assert not b.any()

    def chunk(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            words = pkg.layers.data("words", [8], dtype="int64")
            tags = pkg.layers.data("tags", [8], dtype="int64")
            pkg.evaluator.ChunkEvaluator(words, tags, "IOB", 3)
        return main

    assert chunk(pt).to_dict() == chunk(jf).to_dict()
