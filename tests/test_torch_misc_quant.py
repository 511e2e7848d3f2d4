"""The rest of misc_ops and the quantization ops in the port, against the
JAX package on the CPU.

* the 28 layers of layers/nn.py that build the misc ops run on
  ``CPUPlace()`` in the port, each Program built by both packages and
  run from the JAX startup's weights (``tests/torch_parity.py``): outputs
  within the case's tolerance (exact for integer outputs; ``hash`` is
  bitwise), the random layers by shape, and bitwise twice from one seed
  in the port (ROADMAP's RNG rule);
* ``PADDLE_TPU_OPTIMIZE_QUANT=1``: the level-2 pass inserts the int8
  pair the port now lowers, and the quantized fetches are within the
  pass's ``QUANT_TOLERANCE`` of the float ones and of the JAX package's
  quantized ones;
* ``QuantizeTranspiler.training_transpile``: the fake-quant program
  trains in the port as in the JAX package (its straight-through grads),
  its first loss within ``QUANT_TOLERANCE`` of the untransposed
  program's, and ``freeze_program`` serves it.
"""

import os

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.passes.quantize_pass import QUANT_TOLERANCE
from torch_parity import assert_runs_close, build_both, run_both

RS = np.random.RandomState


def _f(rs, *shape):
    return rs.randn(*shape).astype("float32")


def _i(rs, hi, *shape, lo=0):
    return rs.randint(lo, hi, shape).astype("int64")


# name -> (build(pkg) -> fetches, feeds(rs) -> dict, atol)
LAYERS = {}


def layer(name, atol=1e-5):
    def deco(fn):
        LAYERS[name] = (fn, atol)
        return fn

    return deco


@layer("selu")
def _selu(L, rs):
    return [L.selu(L.data("x", [6]))], {"x": _f(rs, 3, 6)}


@layer("multiplex", 0)
def _multiplex(L, rs):
    a, b = L.data("a", [4]), L.data("b", [4])
    ids = L.data("ids", [1], dtype="int32")
    return [L.multiplex([a, b], ids)], {
        "a": _f(rs, 3, 4), "b": _f(rs, 3, 4),
        "ids": np.array([[1], [0], [1]], "int32")}


@layer("space_to_depth", 0)
def _space_to_depth(L, rs):
    return ([L.space_to_depth(L.data("x", [2, 4, 4]), 2)],
            {"x": _f(rs, 2, 2, 4, 4)})


@layer("shuffle_channel", 0)
def _shuffle_channel(L, rs):
    return ([L.shuffle_channel(L.data("x", [4, 2, 3]), 2)],
            {"x": _f(rs, 2, 4, 2, 3)})


@layer("pad_constant_like", 0)
def _pad_constant_like(L, rs):
    x, y = L.data("x", [5, 3]), L.data("y", [2, 3])
    return ([L.pad_constant_like(x, y, pad_value=0.5)],
            {"x": _f(rs, 2, 5, 3), "y": _f(rs, 2, 2, 3)})


@layer("dice_loss", 1e-6)
def _dice_loss(L, rs):
    x = L.softmax(L.data("x", [3]))
    lab = L.data("lab", [1], dtype="int64")
    return [L.dice_loss(x, lab)], {"x": _f(rs, 5, 3),
                                   "lab": _i(rs, 3, 5, 1)}


@layer("mean_iou", 1e-6)
def _mean_iou(L, rs):
    p = L.data("p", [6], dtype="int32")
    q = L.data("q", [6], dtype="int32")
    return list(L.mean_iou(p, q, 4)), {
        "p": _i(rs, 4, 2, 6).astype("int32"),
        "q": _i(rs, 4, 2, 6).astype("int32")}


@layer("add_position_encoding")
def _add_position_encoding(L, rs):
    return ([L.add_position_encoding(L.data("x", [5, 8]), 0.5, 2.0)],
            {"x": _f(rs, 2, 5, 8)})


@layer("bilinear_tensor_product")
def _bilinear_tensor_product(L, rs):
    x, y = L.data("x", [4]), L.data("y", [5])
    return ([L.bilinear_tensor_product(x, y, 3, act="tanh")],
            {"x": _f(rs, 3, 4), "y": _f(rs, 3, 5)})


@layer("teacher_student_sigmoid_loss", 1e-6)
def _tssl(L, rs):
    x, lab = L.data("x", [1]), L.data("lab", [1])
    return ([L.teacher_student_sigmoid_loss(x, lab)],
            {"x": _f(rs, 4, 1),
             "lab": np.array([[-2.0], [-1.0], [0.4], [1.3]], "float32")})


@layer("npair_loss")
def _npair_loss(L, rs):
    a, p = L.data("a", [4]), L.data("p", [4])
    lab = L.data("lab", [1], dtype="int64")
    return ([L.npair_loss(a, p, lab)],
            {"a": _f(rs, 5, 4), "p": _f(rs, 5, 4),
             "lab": np.array([[1], [2], [1], [3], [2]], "int64")})


@layer("gaussian_random_batch_size_like", None)
def _grbsl(L, rs):
    x = L.data("x", [3])
    return ([L.gaussian_random_batch_size_like(x, [-1, 64], mean=1.0,
                                               std=0.5)],
            {"x": _f(rs, 4, 3)})


@layer("random_crop", None)
def _random_crop(L, rs):
    return ([L.random_crop(L.data("x", [3, 8, 8]), [3, 5, 4])],
            {"x": _f(rs, 2, 3, 8, 8)})


@layer("autoincreased_step_counter", 0)
def _counter(L, rs):
    return [L.autoincreased_step_counter(begin=3, step=2)], {}


@layer("pool3d")
def _pool3d(L, rs):
    x = L.data("x", [2, 4, 5, 4])
    return ([L.pool3d(x, 2, "max", 1, 1),
             L.pool3d(x, 3, "avg", 1, 1, exclusive=True),
             L.pool3d(x, 2, "avg", 2, 0)], {"x": _f(rs, 2, 2, 4, 5, 4)})


@layer("adaptive_pool3d")
def _adaptive_pool3d(L, rs):
    x = L.data("x", [2, 4, 4, 6])
    return ([L.adaptive_pool3d(x, [2, 2, 3], "max"),
             L.adaptive_pool3d(x, [1, 2, 2], "avg")],
            {"x": _f(rs, 2, 2, 4, 4, 6)})


@layer("conv3d_transpose", 1e-4)
def _conv3d_transpose(L, rs):
    x = L.data("x", [3, 3, 4, 3])
    return ([L.conv3d_transpose(x, 2, filter_size=2, stride=2, padding=1)],
            {"x": _f(rs, 2, 3, 3, 4, 3)})


@layer("ctc_greedy_decoder", 0)
def _ctc_greedy_decoder(L, rs):
    x = L.data("x", [7, 5])
    length = L.data("len", [], dtype="int64")
    return (list(L.ctc_greedy_decoder(x, 0, length=length)),
            {"x": _f(rs, 3, 7, 5), "len": np.array([7, 3, 0], "int64")})


@layer("spectral_norm")
def _spectral_norm(L, rs):
    w = L.create_parameter([4, 3, 2], "float32", name="sn_w")
    return [L.spectral_norm(w, dim=1, power_iters=2)], {}


@layer("affine_grid", 1e-6)
def _affine_grid(L, rs):
    theta = L.data("theta", [2, 3])
    return ([L.affine_grid(theta, [2, 1, 3, 4])],
            {"theta": _f(rs, 2, 2, 3)})


@layer("grid_sampler")
def _grid_sampler(L, rs):
    x, g = L.data("x", [2, 5, 4]), L.data("g", [3, 4, 2])
    return ([L.grid_sampler(x, g)],
            {"x": _f(rs, 2, 2, 5, 4),
             "g": (rs.rand(2, 3, 4, 2) * 2.2 - 1.1).astype("float32")})


@layer("sequence_scatter", 1e-6)
def _sequence_scatter(L, rs):
    x = L.data("x", [6])
    ids = L.data("ids", [4], dtype="int64")
    upd = L.data("upd", [4])
    return ([L.sequence_scatter(x, ids, upd)],
            {"x": _f(rs, 2, 6), "ids": _i(rs, 6, 2, 4),
             "upd": _f(rs, 2, 4)})


@layer("data_norm")
def _data_norm(L, rs):
    return [L.data_norm(L.data("x", [4]))], {"x": _f(rs, 5, 4)}


@layer("sampled_softmax_with_cross_entropy", None)
def _sampled_softmax(L, rs):
    logits = L.data("logits", [30])
    lab = L.data("lab", [1], dtype="int64")
    return ([L.sampled_softmax_with_cross_entropy(logits, lab, 6)],
            {"logits": _f(rs, 4, 30), "lab": _i(rs, 30, 4, 1)})


@layer("hash", 0)
def _hash(L, rs):
    ids = L.data("ids", [3], dtype="int64")
    return ([L.hash(ids, 1000, num_hash=2)],
            {"ids": _i(rs, 2 ** 31 - 1, 4, 3, lo=-2 ** 31)})


@layer("psroi_pool")
def _psroi_pool(L, rs):
    x = L.data("x", [8, 5, 6])
    rois = L.data("rois", [4], append_batch_size=False)
    rois.shape = (-1, 4)
    return ([L.psroi_pool(x, rois, 2, 1.0, 2, 2)],
            {"x": _f(rs, 1, 8, 5, 6),
             "rois": np.array([[0.5, 1.0, 4.0, 4.5], [2.0, 0.0, 5.5, 3.5],
                               [1, 1, 2, 2]], "float32")})


@layer("similarity_focus", 0)
def _similarity_focus(L, rs):
    return ([L.similarity_focus(L.data("x", [3, 4, 5]), 1, [0, 2])],
            {"x": _f(rs, 2, 3, 4, 5)})


@layer("tree_conv")
def _tree_conv(L, rs):
    nodes = L.data("nodes", [5, 3])
    edges = L.data("edges", [4, 2], dtype="int64")
    return ([L.tree_conv(nodes, edges, 2, num_filters=2)],
            {"nodes": _f(rs, 2, 5, 3),
             "edges": np.array([[[1, 2], [1, 3], [2, 4], [0, 0]],
                                [[0, 1], [0, 2], [0, 3], [3, 4]]],
                               "int64")})


def test_the_layers_are_the_28_that_build_the_ported_misc_ops():
    """Every layer of layers/nn.py that appends one of misc_ops' ops
    ported here has a case below (the ops' own cases are in
    tests/test_torch_ops.py and tests/test_torch_training.py)."""
    import ast

    from paddle_tpu_torch.core.registry import OPS

    ops = {"selu", "multiplex", "space_to_depth", "shuffle_channel",
           "pad_constant_like", "dice_loss_op", "mean_iou",
           "add_position_encoding", "bilinear_tensor_product",
           "teacher_student_sigmoid_loss", "npair_loss_op",
           "gaussian_random_batch_size_like", "random_crop",
           "increment_counter", "pool3d", "adaptive_pool3d",
           "conv3d_transpose", "ctc_greedy_decoder", "spectral_norm",
           "affine_grid", "grid_sampler", "sequence_scatter", "data_norm",
           "sampled_softmax_with_cross_entropy", "hash_op", "psroi_pool",
           "take_along_axis1", "similarity_focus",
           "roi_perspective_transform", "generate_mask_labels", "tree_conv"}
    assert len(ops) == 31 and ops <= set(OPS)
    path = os.path.join(os.path.dirname(pt.__file__), "layers", "nn.py")
    src = open(path).read()
    builders = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef):
            seg = ast.get_source_segment(src, node)
            if any('"%s"' % o in seg for o in ops):
                builders.add(node.name)
    assert len(builders) == 28 and builders == set(LAYERS)


def _build(name, rs):
    fn, _ = LAYERS[name]
    feeds = {}

    def build(pkg):
        fetches, f = fn(pkg.layers, RS(0))
        feeds.update(f)
        return fetches

    return build, feeds


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_runs_on_the_cpu_against_the_jax_package(name):
    build, feeds = _build(name, RS(0))
    programs = build_both(build)
    feed_list = [feeds, feeds]
    jres, tres, _, _ = run_both(build, feed_list, programs=programs)
    atol = LAYERS[name][1]
    if atol is not None:
        assert_runs_close(jres, tres, atol, rtol=1e-6)
        return
    # a random layer: the JAX package's shapes and dtypes; within the
    # port, the same startup seed draws the same bits, and the second run
    # (the chain advanced) draws others
    for js, ts in zip(jres, tres):
        assert [a.shape for a in js] == [b.shape for b in ts]
        assert [a.dtype for a in js] == [b.dtype for b in ts]
    _, again, _, _ = run_both(build, feed_list, programs=build_both(build))
    for a, b in zip(tres, again):
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert any(x.tobytes() != y.tobytes()
               for x, y in zip(tres[0], tres[1]))


# ------------------------------------------------------ quantization
def _fc_net(pkg, hidden=32):
    L = pkg.layers
    x = L.data("x", [16])
    h = L.fc(x, hidden, act="relu")
    return L.fc(h, 8)


def test_optimize_quant_runs_the_int8_pair_within_tolerance(monkeypatch):
    """With PADDLE_TPU_OPTIMIZE_QUANT=1 the level-2 clone quantizes the
    inference program's weights to int8 (quantize_channel_abs_max /
    dequantize_channel_abs_max, lowered by the port now); its fetches
    stay within QUANT_TOLERANCE of the float program's and of the JAX
    package's quantized fetches."""
    from paddle_tpu_torch.core.passes import optimize_program

    feeds = [{"x": _f(RS(s), 6, 16)} for s in range(2)]
    programs = build_both(lambda pkg: [_fc_net(pkg)])
    plain_j, plain_t, _, tscope = run_both(None, feeds, programs=programs)
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE_QUANT", "1")
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE_QUANT_MIN_ELEMS", "16")
    programs = build_both(lambda pkg: [_fc_net(pkg)])
    quant_j, quant_t, _, tscope = run_both(None, feeds, programs=programs)
    tmain, _, tfetch = programs["port"]
    opt, _ = optimize_program(tmain, fetch_list=[v.name for v in tfetch],
                              scope=tscope, level=2)
    types = [op.type for op in opt.global_block().ops]
    assert types.count("quantize_channel_abs_max") == 2
    assert types.count("dequantize_channel_abs_max") == 2
    assert_runs_close(quant_j, quant_t, 1e-5, rtol=1e-5)
    for q, p in zip(quant_t, plain_t):
        np.testing.assert_allclose(q[0], p[0], **QUANT_TOLERANCE)
        assert q[0].tobytes() != p[0].tobytes()  # the int8 grid shows
    assert_runs_close(plain_j, plain_t, 1e-5)


def _qat_build(pkg, transpile):
    L = pkg.layers
    x = L.data("x", [16])
    y = L.data("y", [1])
    h = L.fc(x, 32, act="relu")
    pred = L.fc(h, 1)
    loss = L.mean(L.square_error_cost(pred, y))
    if transpile:
        pkg.contrib.quantize.QuantizeTranspiler().training_transpile()
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss]


def _qat_feeds(n=4):
    out = []
    for s in range(n):
        rs = RS(s)
        x = _f(rs, 8, 16)
        out.append({"x": x, "y": x[:, :1] * 0.5 + 0.1})
    return out


def test_quantize_transpiler_trains_as_in_the_jax_package():
    """training_transpile inserts fake-quant ops on the weights and
    activations of both products; the port trains the transposed program
    as the JAX package does (straight-through grads), its first loss is
    within QUANT_TOLERANCE of the untransposed program's, and
    freeze_program gives the is_test program that serves the same
    fetches."""
    feeds = _qat_feeds()
    programs = build_both(lambda pkg: _qat_build(pkg, True))
    tmain = programs["port"][0]
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fake_quantize_abs_max") == 2
    assert types.count("fake_quantize_moving_average_abs_max") == 2
    # the backward runs the custom straight-through grad lowerings
    assert types.count("fake_quantize_abs_max_grad") == 2
    jq, tq, _, tscope = run_both(None, feeds, programs=programs)
    assert_runs_close(jq, tq, 1e-5, rtol=1e-5)
    assert tq[-1][0] < tq[0][0]  # it learns
    _, plain, _, _ = run_both(None, feeds[:1], programs=build_both(
        lambda pkg: _qat_build(pkg, False)))
    np.testing.assert_allclose(tq[0][0], plain[0][0], **QUANT_TOLERANCE)
    # freeze: the scales collected in training, read at is_test
    loss = programs["port"][2][0]
    frozen = pt.contrib.quantize.QuantizeTranspiler().freeze_program(
        tmain._prune([loss.name]))
    assert all(op.attrs.get("is_test") for op in frozen.global_block().ops
               if op.type.startswith("fake_quantize"))
    exe = pt.Executor(pt.CPUPlace())
    a = exe.run(frozen, feed=feeds[0], fetch_list=[loss.name],
                scope=tscope)[0]
    b = exe.run(frozen, feed=feeds[0], fetch_list=[loss.name],
                scope=tscope)[0]
    assert np.isfinite(a).all() and a.tobytes() == b.tobytes()


def test_fake_quant_grads_pass_straight_through():
    """The port's fake_quantize grads are the identity on X (their
    custom lowerings), in a Program's backward too: the grad of
    sum(fake_quant(x)) is all ones."""
    from paddle_tpu_torch.core.backward import calc_gradient
    from paddle_tpu_torch.layer_helper import LayerHelper

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [5], stop_gradient=False)
        helper = LayerHelper("fq")
        out = helper.create_variable_for_type_inference("float32")
        scale = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="fake_quantize_abs_max", inputs={"X": [x]},
                         outputs={"Out": [out], "OutScale": [scale]},
                         attrs={"bit_length": 4})
        loss = pt.layers.reduce_sum(out)
        (g,) = calc_gradient([loss], [x])
    exe = pt.Executor(pt.CPUPlace())
    got = exe.run(main, feed={"x": _f(RS(1), 3, 5)}, fetch_list=[g])[0]
    np.testing.assert_array_equal(got, np.ones((3, 5), "float32"))
