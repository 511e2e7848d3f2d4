"""Each op lowering of the port against the JAX package's lowering of the
same op type, on the same inputs (numpy, seeded), one case per op type.

Tolerances: atol 1e-6 for elementwise, shape and pooling ops, 1e-5 for
``mul``, ``conv2d``, ``batch_norm``, ``cross_entropy``,
``layer_norm``, the reductions, division, power and
``softmax_with_cross_entropy`` (f32 sums and transcendentals taken in
another order or by another math library), atol 1e-5 plus rtol 1e-6 for
the activations (exp of inputs up to about 10 differs in the last
place), exact for integer, shape and copy ops, 2e-5 for
``fused_attention`` (the flash kernel's tolerance; the JAX side runs its
Pallas kernel in interpret mode, the port its plain version).
``uniform_random`` and ``gaussian_random`` draw from another generator in
each package, so their cases check shape, range or moments and seeding
instead of values; the metric ops (``top_k``, ``accuracy``, ``auc``,
``precision_recall``) are exact, or 1e-6 where they divide. A float64 output
is float64 in the port and float32 in the JAX package (x64 off), a
documented difference: such outputs are compared in float32. The pass
pipeline's fused ops take their composed replays in both packages (the
port's route for CPU tensors; no tuned winner in the JAX package), at
their constituents' tolerances.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import all_ops, get_op

CPU = torch.device("cpu")


def _arr(rs, shape, dtype="float32"):
    if np.dtype(dtype).kind in "iu":
        return rs.randint(0, 10, shape).astype(dtype)
    return rs.randn(*shape).astype(dtype)


def _run_both(op_type, ins, attrs):
    """(jax outputs, port outputs), each {slot: [numpy]}."""
    import jax.numpy as jnp

    j_ins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    t_ins = {k: [torch.from_numpy(np.array(v)) for v in vs]
             for k, vs in ins.items()}
    j = jax_op(op_type).lowering(JaxContext(None, None), j_ins, dict(attrs))
    t = get_op(op_type).lowering(LowerContext(None, None, CPU), t_ins,
                                 dict(attrs))
    to_np = lambda d: {k: [np.asarray(x) for x in v] for k, v in d.items()}  # noqa: E731
    return to_np(j), {k: [None if x is None else x.numpy() for x in v]
                      for k, v in t.items()}


# documented differences of dtype (ROADMAP §C, C3): the port computes
# float64 for real, the JAX package (x64 off) in float32; such outputs
# are compared at float32
DOCUMENTED_DTYPES = {(np.dtype("float32"), np.dtype("float64"))}


def _check(op_type, ins, attrs, atol, slots=None, rtol=0):
    j, t = _run_both(op_type, ins, attrs)
    for slot in slots or j:
        for a, b in zip(j[slot], t[slot]):
            assert a.shape == b.shape, (op_type, slot, a.shape, b.shape)
            if (a.dtype, b.dtype) in DOCUMENTED_DTYPES:
                b = b.astype(a.dtype)
            assert a.dtype == b.dtype, (op_type, slot, a.dtype, b.dtype)
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg="%s.%s" % (op_type, slot))


def case_mul(rs):
    _check("mul", {"X": [_arr(rs, (2, 3, 4))], "Y": [_arr(rs, (12, 5))]},
           {"x_num_col_dims": 1, "y_num_col_dims": 1}, 1e-5)
    _check("mul", {"X": [_arr(rs, (2, 3, 4))], "Y": [_arr(rs, (4, 6))]},
           {"x_num_col_dims": 2, "y_num_col_dims": 1}, 1e-5)


def case_elementwise_add(rs):
    x = _arr(rs, (2, 3, 4))
    for y, axis in ((_arr(rs, (3,)), 1), (_arr(rs, (4,)), -1),
                    (_arr(rs, (2, 3, 4)), -1), (_arr(rs, (3, 1)), 1),
                    (_arr(rs, (1, 1, 4)), -1)):
        _check("elementwise_add", {"X": [x], "Y": [y]}, {"axis": axis}, 1e-6)


def case_reshape2(rs):
    _check("reshape2", {"X": [_arr(rs, (2, 3, 4))]}, {"shape": [0, -1]},
           1e-6)
    _check("reshape2", {"X": [_arr(rs, (2, 3, 4))]}, {"shape": [-1, 2, 2]},
           1e-6)


def case_transpose2(rs):
    _check("transpose2", {"X": [_arr(rs, (2, 3, 4, 5))]},
           {"axis": [0, 2, 1, 3]}, 1e-6)


def case_layer_norm(rs):
    x = _arr(rs, (2, 3, 8)) * 3 + 1
    _check("layer_norm", {"X": [x], "Scale": [_arr(rs, (8,))],
                          "Bias": [_arr(rs, (8,))]},
           {"begin_norm_axis": 2, "epsilon": 1e-5}, 1e-5)
    _check("layer_norm", {"X": [x], "Scale": [_arr(rs, (24,))],
                          "Bias": [_arr(rs, (24,))]},
           {"begin_norm_axis": 1, "epsilon": 1e-5}, 1e-5)


def case_dropout(rs):
    x = _arr(rs, (4, 6))
    for impl in ("downgrade_in_infer", "upscale_in_train"):
        _check("dropout", {"X": [x]},
               {"dropout_prob": 0.1, "is_test": True,
                "dropout_implementation": impl}, 1e-6)


def case_lookup_table(rs):
    w = _arr(rs, (10, 4))
    _check("lookup_table", {"W": [w], "Ids": [_arr(rs, (2, 3), "int32")]},
           {"padding_idx": -1}, 1e-6)
    _check("lookup_table", {"W": [w], "Ids": [_arr(rs, (2, 3, 1), "int32")]},
           {"padding_idx": 2}, 1e-6)


def case_fill_constant(rs):
    _check("fill_constant", {}, {"shape": [2, 3], "value": 1.5,
                                 "dtype": "float32"}, 1e-6)
    _check("fill_constant", {}, {"shape": [1], "value": 7.0,
                                 "dtype": "int64"}, 0)


def case_unsqueeze2(rs):
    _check("unsqueeze2", {"X": [_arr(rs, (2, 3))]}, {"axes": [1]}, 1e-6)
    _check("unsqueeze2", {"X": [_arr(rs, (2, 3))]}, {"axes": [2, 0]}, 1e-6)


def case_fused_attention(rs):
    q, k, v = (_arr(rs, (2, 2, 40, 16)) for _ in range(3))
    bias = np.zeros((2, 1, 1, 40), "float32")
    bias[1, ..., 30:] = -1e9
    _check("fused_attention", {"Q": [q], "K": [k], "V": [v], "Bias": [bias]},
           {"scale": 0.25, "dropout": 0.0, "causal": False}, 2e-5,
           slots=["Out", "Mask"])
    _check("fused_attention", {"Q": [q], "K": [k], "V": [v]},
           {"scale": 0.25, "dropout": 0.0, "causal": True}, 2e-5,
           slots=["Out"])


def case_relu(rs):
    _check("relu", {"X": [_arr(rs, (3, 5))]}, {}, 1e-6)


def case_scale(rs):
    x = _arr(rs, (3, 5))
    _check("scale", {"X": [x]}, {"scale": 1e9, "bias": -1e9}, 1e-6)
    _check("scale", {"X": [x]}, {"scale": 2.0, "bias": 0.5,
                                 "bias_after_scale": False}, 1e-6)


def case_range(rs):
    ins = {"Start": [np.zeros(1, "int32")], "End": [np.full(1, 12, "int32")],
           "Step": [np.ones(1, "int32")]}
    _check("range", ins, {"static_start": 0.0, "static_end": 12.0,
                          "static_step": 1.0, "dtype": "int64"}, 0)
    # integer bounds past float32's 2**24: exact in both (int32 on device)
    _check("range", ins, {"static_start": 16777217, "static_end": 16777227,
                          "static_step": 1, "dtype": "int64"}, 0)
    fins = {"Start": [np.full(1, 0.5, "float32")],
            "End": [np.full(1, 4.0, "float32")],
            "Step": [np.full(1, 0.5, "float32")]}
    _check("range", fins, {}, 1e-6)


def case_uniform_random(rs):
    attrs = {"shape": [64, 32], "min": -0.25, "max": 0.5, "seed": 0,
             "dtype": "float32"}

    def draw(chain_seed, **over):
        ctx = LowerContext(None, torch.Generator().manual_seed(chain_seed),
                           CPU)
        return get_op("uniform_random").lowering(
            ctx, {}, dict(attrs, **over))["Out"][0]

    import jax

    want = np.asarray(jax_op("uniform_random").lowering(
        JaxContext(None, jax.random.PRNGKey(0)), {}, dict(attrs))["Out"][0])
    a = draw(3)
    assert tuple(a.shape) == want.shape and a.dtype == torch.float32
    assert want.dtype == np.float32
    assert float(a.min()) >= -0.25 and float(a.max()) < 0.5
    assert float(a.max()) - float(a.min()) > 0.7  # spans the range
    torch.testing.assert_close(draw(3), a, rtol=0, atol=0)  # same seed
    assert not torch.equal(draw(4), a)                      # other seed
    # a nonzero seed attr fixes the draw whatever the context's chain
    torch.testing.assert_close(draw(3, seed=9), draw(4, seed=9),
                               rtol=0, atol=0)


def _ew_case(op_type):
    def case(rs):
        x = _arr(rs, (2, 3, 4))
        if op_type == "elementwise_pow":
            x = np.abs(x) + 0.5
        for y, axis in ((_arr(rs, (3,)), 1), (_arr(rs, (2, 3, 4)), -1),
                        (_arr(rs, (1, 1, 4)), -1)):
            if op_type in ("elementwise_div", "elementwise_mod",
                           "elementwise_floordiv"):
                y = np.where(np.abs(y) < 0.3, 0.7, y).astype("float32")
            _check(op_type, {"X": [x], "Y": [y]}, {"axis": axis}, 1e-5)
        if op_type in ("elementwise_mod", "elementwise_floordiv"):
            xi = _arr(rs, (2, 5), "int32") - 4
            yi = np.array([3, -2, 5, 4, 7], "int32")
            _check(op_type, {"X": [xi], "Y": [yi]}, {"axis": -1}, 0)

    return case


for _op in ("sub", "mul", "div", "max", "min", "pow", "mod", "floordiv"):
    globals()["case_elementwise_" + _op] = _ew_case("elementwise_" + _op)


def _py_forward(x, y):
    return 2 * x + y, x * y


def _py_backward(da, db):
    return 2 * da + db, da + db


def case_py_layer(rs):
    # the dygraph PyLayer's host callback (imperative/__init__.py): the
    # user's numpy forward on both packages' inputs
    xs = [_arr(rs, (3, 4)) for _ in range(2)]
    _check("py_layer", {"X": xs}, {"__forward__": _py_forward,
                                   "__backward__": _py_backward}, 0)


def case_sum(rs):
    xs = [_arr(rs, (3, 4)) for _ in range(3)]
    _check("sum", {"X": xs}, {}, 1e-6)


def case_mean(rs):
    _check("mean", {"X": [_arr(rs, (3, 4))]}, {}, 1e-6)
    _check("mean", {"X": [_arr(rs, (3, 4), "int32")]}, {}, 1e-6)


def _reduce_case(op_type, atol):
    def case(rs):
        x = _arr(rs, (2, 3, 4))
        if op_type == "reduce_prod":
            x = np.abs(x) * 0.5 + 0.75
        if op_type in ("reduce_all", "reduce_any"):
            x = rs.rand(2, 3, 4) > 0.3
        for attrs in ({"dim": [1]}, {"dim": [0, -1], "keep_dim": True},
                      {"reduce_all": True}, {"dim": [2], "keep_dim": True}):
            _check(op_type, {"X": [x]}, attrs, atol)
        if op_type in ("reduce_sum", "reduce_prod"):
            _check(op_type, {"X": [_arr(rs, (3, 4), "int32")]}, {"dim": [1]},
                   0)

    return case


for _op, _tol in (("sum", 1e-5), ("mean", 1e-6), ("max", 0), ("min", 0),
                  ("prod", 1e-5), ("all", 0), ("any", 0)):
    globals()["case_reduce_" + _op] = _reduce_case("reduce_" + _op, _tol)


def case_assign(rs):
    _check("assign", {"X": [_arr(rs, (3, 4))]}, {}, 0)


def case_cast(rs):
    x = _arr(rs, (3, 4)) * 4
    for dt in ("int32", "float16", "bool", "float32"):
        _check("cast", {"X": [x]}, {"out_dtype": dt}, 0)
    _check("cast", {"X": [_arr(rs, (3, 4), "int32")]},
           {"out_dtype": "int64"}, 0)
    # float64: float64 in the port, float32 in the reference (C3)
    _check("cast", {"X": [x]}, {"out_dtype": "float64"}, 0)


def case_reshape(rs):
    _check("reshape", {"X": [_arr(rs, (2, 3, 4))]}, {"shape": [0, -1]}, 0)


def case_transpose(rs):
    _check("transpose", {"X": [_arr(rs, (2, 3, 4))]}, {"axis": [2, 0, 1]},
           0)


def case_gather(rs):
    x = _arr(rs, (6, 4))
    _check("gather", {"X": [x], "Index": [np.array([0, 3, 3, 5], "int32")]},
           {}, 0)
    _check("gather", {"X": [x], "Index": [np.array([[1], [1], [2]],
                                                   "int32")]}, {}, 0)
    _check("gather", {"X": [_arr(rs, (2, 5, 3))],
                      "Index": [np.array([4, 0, 4], "int32")]}, {"axis": 1},
           0)


def case_softmax_with_cross_entropy(rs):
    logits = _arr(rs, (6, 7)) * 2
    label = np.array([[0], [3], [6], [-100], [2], [3]], "int32")
    _check("softmax_with_cross_entropy",
           {"Logits": [logits], "Label": [label]}, {}, 1e-5)
    _check("softmax_with_cross_entropy",
           {"Logits": [logits], "Label": [np.abs(label) % 7]},
           {"ignore_index": 3}, 1e-5)
    soft = rs.rand(6, 7).astype("float32")
    _check("softmax_with_cross_entropy",
           {"Logits": [logits], "Label": [soft / soft.sum(-1, keepdims=True)]},
           {"soft_label": True}, 1e-5)


def case_clip(rs):
    _check("clip", {"X": [_arr(rs, (4, 5))]}, {"min": -0.5, "max": 0.7}, 0)


def case_clip_by_norm(rs):
    x = _arr(rs, (4, 5))
    for max_norm in (1.0, 100.0):
        _check("clip_by_norm", {"X": [x]}, {"max_norm": max_norm}, 1e-6)


def case_sign(rs):
    x = _arr(rs, (4, 5))
    x[0, :2] = 0.0
    _check("sign", {"X": [x]}, {}, 0)


def case_squared_l2_norm(rs):
    _check("squared_l2_norm", {"X": [_arr(rs, (4, 5))]}, {}, 1e-5)


def _opt_ins(rs, shape=(4, 3)):
    return {"Param": [_arr(rs, shape)], "Grad": [_arr(rs, shape)],
            "LearningRate": [np.full(1, 0.01, "float32")]}


def case_sgd(rs):
    _check("sgd", _opt_ins(rs), {}, 1e-6)


def case_momentum(rs):
    ins = dict(_opt_ins(rs), Velocity=[_arr(rs, (4, 3))])
    for nesterov in (False, True):
        _check("momentum", ins, {"mu": 0.9, "use_nesterov": nesterov}, 1e-6)


def case_adam(rs):
    ins = dict(_opt_ins(rs), Moment1=[_arr(rs, (4, 3)) * 0.1],
               Moment2=[np.abs(_arr(rs, (4, 3))) * 0.01],
               Beta1Pow=[np.full(1, 0.9 ** 3, "float32")],
               Beta2Pow=[np.full(1, 0.999 ** 3, "float32")])
    _check("adam", ins, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
           1e-6)
    _check("adam", ins, {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6,
                         "weight_decay": 0.01}, 1e-6)


# the other nine optimizer ops (tests/test_torch_optimizer_ops.py
# holds their attr variants and classes)
def _pos(rs, shape=(4, 3)):
    return np.abs(_arr(rs, shape)) + 0.1


def case_lars_momentum(rs):
    _check("lars_momentum", dict(_opt_ins(rs), Velocity=[_arr(rs, (4, 3))]),
           {"mu": 0.9, "lars_coeff": 1e-3, "lars_weight_decay": 5e-4}, 1e-6)


def case_adamax(rs):
    _check("adamax", dict(_opt_ins(rs), Moment=[_arr(rs, (4, 3))],
                          InfNorm=[_pos(rs)],
                          Beta1Pow=[np.full(1, 0.9 ** 3, "float32")]),
           {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, 1e-6)


def case_adagrad(rs):
    _check("adagrad", dict(_opt_ins(rs), Moment=[_pos(rs)]),
           {"epsilon": 1e-6}, 1e-6)


def case_decayed_adagrad(rs):
    _check("decayed_adagrad", dict(_opt_ins(rs), Moment=[_pos(rs)]),
           {"decay": 0.95, "epsilon": 1e-6}, 1e-6)


def case_adadelta(rs):
    _check("adadelta", {"Param": [_arr(rs, (4, 3))], "Grad": [_arr(rs, (4, 3))],
                        "AvgSquaredGrad": [_pos(rs)],
                        "AvgSquaredUpdate": [_pos(rs)]},
           {"rho": 0.95, "epsilon": 1e-6}, 1e-6)


def case_rmsprop(rs):
    ins = dict(_opt_ins(rs), MeanSquare=[_pos(rs)], Moment=[_arr(rs, (4, 3))],
               MeanGrad=[_arr(rs, (4, 3)) * 0.01])
    for centered in (False, True):
        _check("rmsprop", ins, {"decay": 0.9, "epsilon": 1e-6,
                                "momentum": 0.5, "centered": centered}, 1e-6)


def case_ftrl(rs):
    ins = dict(_opt_ins(rs), SquaredAccumulator=[_pos(rs)],
               LinearAccumulator=[_arr(rs, (4, 3))])
    for power, l1 in ((-0.5, 0.0), (-0.6, 0.5)):
        _check("ftrl", ins, {"l1": l1, "l2": 0.1, "lr_power": power}, 1e-6,
               rtol=1e-6)


def case_lamb(rs):
    ins = dict(_opt_ins(rs), Moment1=[_arr(rs, (4, 3)) * 0.1],
               Moment2=[np.abs(_arr(rs, (4, 3))) * 0.01],
               Beta1Pow=[np.full(1, 0.81, "float32")],
               Beta2Pow=[np.full(1, 0.998, "float32")])
    _check("lamb", ins, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                         "weight_decay": 0.01}, 1e-6)


def case_average_accumulates(rs):
    zeros = np.zeros((4, 3), "float32")
    _check("average_accumulates",
           {"param": [_arr(rs, (4, 3))], "in_sum_1": [_arr(rs, (4, 3))],
            "in_sum_2": [zeros], "in_sum_3": [zeros],
            "in_num_accumulates": [np.array([2], "int32")],
            "in_old_num_accumulates": [np.array([0], "int32")],
            "in_num_updates": [np.array([16383], "int32")]},
           {"average_window": 0.5, "min_average_window": 2,
            "max_average_window": 3}, 0)


def case_assign_value(rs):
    _check("assign_value", {}, {"values": [0.5, -1.25, 3.0, 7.0],
                                "shape": [2, 2], "dtype": "float32"}, 0)
    _check("assign_value", {}, {"values": [3, 1, 4], "shape": [3],
                                "dtype": "int32"}, 0)


# the pass pipeline's fused ops (core/passes): each package's composed
# replay of the constituents' lowerings (the port's CPU route; no tuned
# winner in the JAX package)
def case_fused_elementwise(rs):
    ops = [{"type": "elementwise_add", "attrs": {"axis": -1},
            "ins": {"X": [["x", 0]], "Y": [["x", 1]]}, "out_slot": "Out"},
           {"type": "scale", "attrs": {"scale": 0.5, "bias": 1.0},
            "ins": {"X": [["t", 0]]}, "out_slot": "Out"},
           {"type": "tanh", "attrs": {}, "ins": {"X": [["t", 1]]},
            "out_slot": "Out"}]
    _check("fused_elementwise", {"X": [_arr(rs, (3, 4)), _arr(rs, (4,))]},
           {"ops": ops}, 1e-6)


def case_fused_layernorm_residual(rs):
    x, r = _arr(rs, (2, 3, 8)), _arr(rs, (2, 3, 8))
    _check("fused_layernorm_residual",
           {"X": [x], "Residual": [r], "Scale": [_arr(rs, (8,))],
            "Bias": [_arr(rs, (8,))]},
           {"add_attrs": {"axis": -1},
            "ln_attrs": {"begin_norm_axis": 2, "epsilon": 1e-5}}, 1e-5)


def case_fused_optimizer_update(rs):
    shapes = [(4, 3), (5,)]
    lr = np.full(1, 0.01, "float32")
    sgd = {"Param": [_arr(rs, s) for s in shapes],
           "Grad": [_arr(rs, s) for s in shapes], "LearningRate": [lr, lr]}
    _check("fused_optimizer_update", sgd, {"kind": "sgd", "hyper": {}}, 1e-6)
    adam = dict(sgd, Moment1=[_arr(rs, s) * 0.1 for s in shapes],
                Moment2=[np.abs(_arr(rs, s)) * 0.01 for s in shapes],
                Beta1Pow=[np.full(1, 0.9 ** k, "float32") for k in (2, 3)],
                Beta2Pow=[np.full(1, 0.999 ** k, "float32") for k in (2, 3)])
    _check("fused_optimizer_update", adam,
           {"kind": "adam", "hyper": {"beta1": 0.9, "beta2": 0.999,
                                      "epsilon": 1e-8,
                                      "weight_decay": 0.01}}, 1e-6)


# the learning-rate schedules' ops (layers/learning_rate_scheduler.py)
def case_increment(rs):
    _check("increment", {"X": [np.full(1, 3.0, "float32")]}, {"step": 1.0},
           0)
    _check("increment", {"X": [_arr(rs, (2, 3))]}, {"step": -2.5}, 0)


def _cmp_case(op_type):
    def case(rs):
        x = np.round(_arr(rs, (2, 3, 4)))  # ties for the equalities
        for y, axis in ((np.round(_arr(rs, (2, 3, 4))), -1),
                        (np.round(_arr(rs, (3,))), 1),
                        (np.round(_arr(rs, (4,))), -1),
                        (np.zeros(1, "float32"), -1)):
            _check(op_type, {"X": [x], "Y": [y]}, {"axis": axis}, 0)
        ids = _arr(rs, (3, 4), "int32")
        _check(op_type, {"X": [ids], "Y": [np.full(1, 5, "int32")]}, {}, 0)

    return case


for _op in ("less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal"):
    globals()["case_" + _op] = _cmp_case(_op)


def case_where_op(rs):
    cond = rs.rand(3, 4) < 0.5
    _check("where_op", {"Condition": [cond], "X": [_arr(rs, (3, 4))],
                        "Y": [_arr(rs, (3, 4))]}, {}, 0)
    _check("where_op", {"Condition": [np.array([True])],
                        "X": [np.full(1, 2.0, "float32")],
                        "Y": [np.full(1, 3.0, "float32")]}, {}, 0)


# the ops transformer and GPT add (the edge cases: test_torch_decode_ops.py)
def case_concat(rs):
    xs = [_arr(rs, (2, n, 3)) for n in (1, 4, 2)]
    _check("concat", {"X": xs}, {"axis": 1}, 0)
    _check("concat", {"X": [_arr(rs, (2, 3), "int32"),
                            _arr(rs, (1, 3), "int32")]}, {}, 0)


def case_stack(rs):
    xs = [_arr(rs, (2, 3)) for _ in range(3)]
    _check("stack", {"X": xs}, {"axis": 1}, 0)
    _check("stack", {"X": xs}, {}, 0)


def case_slice(rs):
    x = _arr(rs, (3, 8, 4))
    _check("slice", {"Input": [x]}, {"axes": [1], "starts": [1],
                                     "ends": [8]}, 0)
    _check("slice", {"Input": [x]}, {"axes": [0, 2], "starts": [-2, 1],
                                     "ends": [100, -1]}, 0)


def case_fill_constant_batch_size_like(rs):
    ref = _arr(rs, (5, 3), "int32")
    _check("fill_constant_batch_size_like", {"Input": [ref]},
           {"shape": [-1, 1], "dtype": "int64", "value": 0}, 0)
    _check("fill_constant_batch_size_like", {"Input": [ref]},
           {"shape": [2, -1, 4], "dtype": "float32", "value": 1.5,
            "input_dim_idx": 1, "output_dim_idx": 1}, 0)


def case_matmul(rs):
    x, y = _arr(rs, (2, 3, 5, 4)), _arr(rs, (2, 3, 6, 4))
    _check("matmul", {"X": [x], "Y": [y]},
           {"transpose_Y": True, "alpha": 0.125}, 1e-5)
    _check("matmul", {"X": [_arr(rs, (4, 5))], "Y": [_arr(rs, (5, 3))]},
           {}, 1e-5)


def case_softmax(rs):
    _check("softmax", {"X": [_arr(rs, (3, 4, 7)) * 3]}, {}, 1e-6)
    _check("softmax", {"X": [_arr(rs, (3, 4, 7))]}, {"axis": 1}, 1e-6)


def case_one_hot(rs):
    _check("one_hot", {"X": [_arr(rs, (3, 5, 1), "int32")]}, {"depth": 10},
           0)
    _check("one_hot", {"X": [_arr(rs, (4,), "int32")]}, {"depth": 7}, 0)


def case_label_smooth(rs):
    x = np.eye(6, dtype="float32")[rs.randint(0, 6, (2, 3))]
    _check("label_smooth", {"X": [x]}, {"epsilon": 0.1}, 1e-7)
    prior = rs.rand(6).astype("float32")
    _check("label_smooth", {"X": [x], "PriorDist": [prior / prior.sum()]},
           {"epsilon": 0.2}, 1e-7)


def case_rms_norm(rs):
    x = _arr(rs, (2, 3, 8)) * 3
    _check("rms_norm", {"X": [x], "Scale": [_arr(rs, (8,))]},
           {"begin_norm_axis": 2, "epsilon": 1e-6}, 1e-5)
    _check("rms_norm", {"X": [x]}, {"begin_norm_axis": 1}, 1e-5)


def case_rope(rs):
    x = _arr(rs, (2, 3, 6, 8))
    _check("rope", {"X": [x], "Pos": [np.arange(6).astype("int32")]}, {},
           1e-5)
    _check("rope", {"X": [x], "Pos": [np.array([5], "int32")]},
           {"base": 500.0}, 1e-5)


def case_kv_cache_write(rs):
    cache = _arr(rs, (2, 3, 8, 4))
    _check("kv_cache_write", {"Cache": [cache], "Update": [
        _arr(rs, (2, 3, 1, 4))], "Pos": [np.array([5], "int32")]}, {}, 0)
    _check("kv_cache_write", {"Cache": [cache], "Update": [
        _arr(rs, (2, 3, 3, 4))], "Pos": [np.array([[1], [4]], "int32")]},
        {}, 0)


# the image-classification slice's ops (conv, pool, norm, loss, metrics):
# the cases of tests/test_torch_vision.py hold their edges, grads and
# ties further
def case_conv2d(rs):
    x = _arr(rs, (2, 4, 9, 8))
    for w_shape, attrs in (
            ((6, 4, 3, 3), {"strides": [1, 1], "paddings": [1, 1]}),
            ((6, 4, 3, 2), {"strides": [2, 1], "paddings": [0, 1],
                            "dilations": [2, 1]}),
            ((8, 2, 3, 3), {"strides": [2, 2], "paddings": [1, 1],
                            "groups": 2}),
            ((4, 1, 3, 3), {"paddings": [2, 2], "dilations": [2, 2],
                            "groups": 4})):
        _check("conv2d", {"Input": [x], "Filter": [_arr(rs, w_shape)]},
               attrs, 1e-5)


def case_pool2d(rs):
    x = _arr(rs, (2, 3, 7, 6))
    for attrs in (
            {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1]},
            {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
             "ceil_mode": True},
            {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1]},
            {"pooling_type": "avg", "ksize": [3, 2], "strides": [1, 2],
             "paddings": [1, 0], "exclusive": False},
            {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
             "exclusive": True},
            {"pooling_type": "avg", "global_pooling": True},
            {"pooling_type": "max", "global_pooling": True,
             "ksize": [2, 2]}):
        _check("pool2d", {"X": [x]}, attrs, 1e-6)
    _check("pool2d", {"X": [_arr(rs, (2, 3, 7, 6), "int32") - 5]},
           {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
            "paddings": [1, 1]}, 0)


def case_batch_norm(rs):
    def ins(x, c):
        return {"X": [x], "Scale": [_arr(rs, (c,))],
                "Bias": [_arr(rs, (c,))], "Mean": [_arr(rs, (c,))],
                "Variance": [np.abs(_arr(rs, (c,))) + 0.5]}

    x = _arr(rs, (4, 3, 5, 6)) * 2 + 1
    for attrs in ({}, {"momentum": 0.8, "epsilon": 1e-3},
                  {"is_test": True}, {"use_global_stats": True}):
        _check("batch_norm", ins(x, 3), attrs, 1e-5)
    _check("batch_norm", ins(x.transpose(0, 2, 3, 1).copy(), 3),
           {"data_layout": "NHWC"}, 1e-5)
    _check("batch_norm", ins(_arr(rs, (6, 5)), 5), {}, 1e-5)


def case_gaussian_random(rs):
    attrs = {"shape": [256, 64], "mean": 0.5, "std": 2.0, "seed": 0,
             "dtype": "float32"}

    def draw(chain_seed, **over):
        ctx = LowerContext(None, torch.Generator().manual_seed(chain_seed),
                           CPU)
        return get_op("gaussian_random").lowering(
            ctx, {}, dict(attrs, **over))["Out"][0]

    import jax

    want = np.asarray(jax_op("gaussian_random").lowering(
        JaxContext(None, jax.random.PRNGKey(0)), {}, dict(attrs))["Out"][0])
    a = draw(3)
    assert tuple(a.shape) == want.shape and a.dtype == torch.float32
    assert want.dtype == np.float32
    # 16384 draws: the moments within 5 standard errors of the JAX
    # package's and of the attrs'
    for got in (a.numpy(), want):
        assert abs(got.mean() - 0.5) < 5 * 2.0 / 128
        assert abs(got.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * 16384)
    torch.testing.assert_close(draw(3), a, rtol=0, atol=0)  # same seed
    assert not torch.equal(draw(4), a)                      # other seed
    # a nonzero seed attr fixes the draw whatever the context's chain
    torch.testing.assert_close(draw(3, seed=9), draw(4, seed=9),
                               rtol=0, atol=0)


def case_cross_entropy(rs):
    p = rs.rand(6, 7).astype("float32")
    p /= p.sum(-1, keepdims=True)
    p[0, 2] = 0.0  # log(0 + 1e-8)
    hard = np.array([2, 3, 6, 0, 1, 3], "int32")
    _check("cross_entropy", {"X": [p], "Label": [hard]}, {}, 1e-5)
    _check("cross_entropy", {"X": [p], "Label": [hard[:, None]]}, {}, 1e-5)
    # -100 (the default ignore_index) and 3 ignored; -1 wraps to the last
    # class and 7 lies outside [-7, 7): NaN in both packages
    odd = np.array([[-100], [3], [-1], [7], [1], [-8]], "int32")
    _check("cross_entropy", {"X": [p], "Label": [odd]}, {}, 1e-5)
    _check("cross_entropy", {"X": [p], "Label": [odd]},
           {"ignore_index": 3}, 1e-5)
    soft = rs.rand(6, 7).astype("float32")
    _check("cross_entropy", {"X": [p], "Label": [soft / soft.sum(-1,
                                                                 keepdims=True)]},
           {"soft_label": True}, 1e-5)


def case_top_k(rs):
    x = rs.randint(0, 4, (5, 9)).astype("float32")  # many ties
    for k in (1, 3, 9):
        _check("top_k", {"X": [x]}, {"k": k}, 0)
    _check("top_k", {"X": [_arr(rs, (2, 3, 8))]}, {"k": 4}, 0)


def case_accuracy(rs):
    x = rs.rand(8, 10).astype("float32")
    label = rs.randint(0, 10, (8, 1)).astype("int32")
    for k in (1, 5):
        order = np.argsort(-x, axis=1, kind="stable")[:, :k]
        _check("accuracy", {"Out": [np.take_along_axis(x, order, 1)],
                            "Indices": [order.astype("int32")],
                            "Label": [label]}, {}, 0)
    _check("accuracy", {"Out": [x[:, :1]], "Indices": [np.zeros(
        (8, 1), "int32")], "Label": [label[:, 0]]}, {}, 0)


def case_auc(rs):
    n_thresh = 50
    for preds in (rs.rand(16, 2).astype("float32"),
                  rs.rand(16, 1).astype("float32")):
        preds[:3] = [[0.0], [1.0], [0.5]] if preds.shape[1] == 1 else \
            [[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]]
        _check("auc", {"Predict": [preds],
                       "Label": [rs.randint(0, 2, (16, 1)).astype("int32")],
                       "StatPos": [rs.randint(0, 5, (n_thresh + 1,)).astype(
                           "int32")],
                       "StatNeg": [rs.randint(0, 5, (n_thresh + 1,)).astype(
                           "int32")]},
               {"curve": "ROC", "num_thresholds": n_thresh}, 1e-6)
    zeros = np.zeros((n_thresh + 1,), "int32")
    _check("auc", {"Predict": [rs.rand(4, 2).astype("float32")],
                   "Label": [np.ones((4, 1), "int32")],
                   "StatPos": [zeros], "StatNeg": [zeros]},
           {"num_thresholds": n_thresh}, 0)


def case_precision_recall(rs):
    idx = rs.randint(0, 4, (12, 1)).astype("int32")
    label = rs.randint(0, 4, (12, 1)).astype("int32")
    _check("precision_recall", {"Indices": [idx], "Label": [label]},
           {"class_number": 4}, 1e-6)
    _check("precision_recall", {
        "Indices": [idx], "Label": [label],
        "Weights": [rs.rand(12, 1).astype("float32")],
        "StatesInfo": [rs.randint(0, 6, (5, 4)).astype("float32")]},
        {"class_number": 5}, 1e-6)

def _recompute_segment(pkg):
    """A program of [fc, tanh] moved into one recompute segment by each
    package's core/recompute.py: (its global block, the recompute_block
    op)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [6])
        h = pkg.layers.fc(x, 5, act="tanh")
        pkg.layers.mean(pkg.layers.scale(h, 2.0))
    from importlib import import_module

    import_module(pkg.__name__ + ".core.recompute").apply_recompute(
        main, [h])
    block = main.global_block()
    return block, next(op for op in block.ops
                       if op.type == "recompute_block")


def case_recompute_block(rs):
    import jax.numpy as jnp

    import paddle_tpu as jf
    import paddle_tpu_torch as pt

    jblock, jop = _recompute_segment(jf)
    tblock, top = _recompute_segment(pt)
    assert top.attrs == jop.attrs and top.inputs == jop.inputs
    shapes = {"x": (3, 6), "fc_0.w_0": (6, 5), "fc_0.b_0": (5,)}
    xs = [_arr(rs, shapes[n]) for n in jop.attrs["input_vars"]]
    j = jax_op("recompute_block").lowering(
        JaxContext(jblock, None), {"X": [jnp.asarray(v) for v in xs]},
        dict(jop.attrs))
    t = get_op("recompute_block").lowering(
        LowerContext(tblock, None, CPU),
        {"X": [torch.from_numpy(v) for v in xs]}, dict(top.attrs))
    (a,), (b,) = j["Out"], t["Out"]
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


# ---- the sequence, recurrent, control-flow and beam-search slice. The
# sequence ops run on ragged lengths holding 1 and T (atol 1e-6 for the
# masked copies and pools, 1e-5 for sequence_conv's and row_conv's sums
# and sequence_softmax's exp); tests/test_torch_sequence.py holds each
# pool type and every grad. The recurrent ops' loops take 1e-5 (f32
# products summed in another order at each step).
_LENS = np.array([1, 5, 3, 5], "int32")  # T = 5


def case_sequence_mask(rs):
    _check("sequence_mask", {"X": [_LENS]}, {"maxlen": 5}, 0)
    _check("sequence_mask", {"X": [_LENS]},
           {"maxlen": 6, "out_dtype": "int64"}, 0)


def case_sequence_pool(rs):
    for ptype in ("average", "sum", "sqrt", "max", "last", "first"):
        _check("sequence_pool", {"X": [_arr(rs, (4, 5, 3))],
                                 "Length": [_LENS]},
               {"pool_type": ptype}, 1e-6)


def case_sequence_softmax(rs):
    _check("sequence_softmax", {"X": [_arr(rs, (4, 5))], "Length": [_LENS]},
           {}, 1e-6, rtol=1e-6)


def case_sequence_reverse(rs):
    _check("sequence_reverse", {"X": [_arr(rs, (4, 5, 2))],
                                "Length": [_LENS]}, {}, 0)


def case_sequence_expand(rs):
    _check("sequence_expand", {"X": [_arr(rs, (3, 4))],
                               "Y": [_arr(rs, (3, 2, 4))]}, {}, 0)


def case_sequence_expand_as(rs):
    _check("sequence_expand_as", {"X": [_arr(rs, (2, 4))],
                                  "Y": [_arr(rs, (6, 4))]}, {}, 0)


def case_sequence_conv(rs):
    for ctx_len, start in ((3, -1), (2, 0), (4, -3)):
        _check("sequence_conv", {"X": [_arr(rs, (4, 5, 3))],
                                 "Filter": [_arr(rs, (ctx_len * 3, 6))],
                                 "Length": [_LENS]},
               {"context_length": ctx_len, "context_start": start}, 1e-5)


def case_sequence_pad(rs):
    x = _arr(rs, (4, 5, 2))
    _check("sequence_pad", {"X": [x], "Length": [_LENS]}, {}, 0)
    _check("sequence_pad", {"X": [x], "Length": [_LENS],
                            "PadValue": [np.array([2.5], "float32")]}, {}, 0)


def case_sequence_unpad(rs):
    _check("sequence_unpad", {"X": [_arr(rs, (4, 5, 2))],
                              "Length": [_LENS]}, {}, 0)


def case_sequence_concat(rs):
    _check("sequence_concat", {"X": [_arr(rs, (4, 5, 2)),
                                     _arr(rs, (4, 3, 2))],
                               "Length": [_LENS,
                                          np.array([3, 1, 2, 3], "int32")]},
           {}, 0)


def case_sequence_slice(rs):
    _check("sequence_slice", {"X": [_arr(rs, (4, 5, 2))],
                              "Offset": [np.array([[0], [1], [4], [2]],
                                                  "int32")],
                              "SliceLength": [np.array([[1], [4], [1],
                                                        [3]], "int32")]},
           {}, 0)


def case_sequence_enumerate(rs):
    x = rs.randint(1, 9, (4, 5)).astype("int32")
    _check("sequence_enumerate", {"X": [x], "Length": [_LENS]},
           {"win_size": 3, "pad_value": 0}, 0)
    _check("sequence_enumerate", {"X": [x]}, {"win_size": 2,
                                               "pad_value": 7}, 0)


def case_sequence_erase(rs):
    x = rs.randint(0, 5, (4, 5)).astype("int32")
    _check("sequence_erase", {"X": [x], "Length": [_LENS]},
           {"tokens": [2, 3]}, 0)
    _check("sequence_erase", {"X": [x], "Length": [_LENS]},
           {"tokens": []}, 0)


def case_row_conv(rs):
    _check("row_conv", {"X": [_arr(rs, (2, 5, 3))],
                        "Filter": [_arr(rs, (3, 3))]}, {}, 1e-5)


def case_lstm(rs):
    D = 4
    ins = {"Input": [_arr(rs, (4, 5, 4 * D))], "Weight": [_arr(rs, (D, 4 * D))],
           "Bias": [_arr(rs, (1, 4 * D))], "Length": [_LENS]}
    for attrs in ({}, {"is_reverse": True},
                  {"gate_activation": "sigmoid", "cell_activation": "relu",
                   "candidate_activation": "identity"}):
        _check("lstm", ins, attrs, 1e-5)
    _check("lstm", dict(ins, H0=[_arr(rs, (4, D))], C0=[_arr(rs, (4, D))],
                        Length=[]), {}, 1e-5)


def case_gru(rs):
    D = 4
    ins = {"Input": [_arr(rs, (4, 5, 3 * D))], "Weight": [_arr(rs, (D, 3 * D))],
           "Bias": [_arr(rs, (1, 3 * D))], "Length": [_LENS]}
    for attrs in ({}, {"is_reverse": True}, {"origin_mode": True}):
        _check("gru", ins, attrs, 1e-5)
    _check("gru", dict(ins, H0=[_arr(rs, (4, D))], Length=[]),
           {"is_reverse": True, "origin_mode": True}, 1e-5)


def case_lstmp(rs):
    D, P = 4, 3
    _check("lstmp", {"Input": [_arr(rs, (4, 5, 4 * D))],
                     "Weight": [_arr(rs, (P, 4 * D))],
                     "ProjWeight": [_arr(rs, (D, P))],
                     "Bias": [_arr(rs, (1, 4 * D))], "Length": [_LENS]},
           {}, 1e-5)


def case_gru_unit(rs):
    D = 4
    ins = {"Input": [_arr(rs, (3, 3 * D))], "HiddenPrev": [_arr(rs, (3, D))],
           "Weight": [_arr(rs, (D, 3 * D))], "Bias": [_arr(rs, (1, 3 * D))]}
    for attrs in ({}, {"origin_mode": True}):
        _check("gru_unit", ins, attrs, 1e-5)


def case_lstm_unit(rs):
    _check("lstm_unit", {"X": [_arr(rs, (3, 16))], "C_prev": [_arr(rs, (3, 4))]},
           {"forget_bias": 1.0}, 1e-6)


def case_is_empty(rs):
    _check("is_empty", {"X": [_arr(rs, (2, 3))]}, {}, 0)
    _check("is_empty", {"X": [np.zeros((0, 3), "float32")]}, {}, 0)


def case_print_op(rs):
    _check("print_op", {"X": [_arr(rs, (2, 3))]},
           {"message": "value", "name": "x"}, 0)


def case_logical_and(rs):
    x, y = rs.rand(3, 4) < 0.5, rs.rand(3, 4) < 0.5
    for op in ("logical_and", "logical_or", "logical_xor"):
        _check(op, {"X": [x], "Y": [y]}, {}, 0)


def case_logical_or(rs):
    _check("logical_or", {"X": [rs.rand(5) < 0.5], "Y": [rs.rand(5) < 0.5]},
           {}, 0)


def case_logical_xor(rs):
    _check("logical_xor", {"X": [rs.rand(5) < 0.5], "Y": [rs.rand(5) < 0.5]},
           {}, 0)


def case_logical_not(rs):
    _check("logical_not", {"X": [rs.rand(3, 4) < 0.5]}, {}, 0)


def case_expand(rs):
    _check("expand", {"X": [_arr(rs, (2, 1, 3))]},
           {"expand_times": [1, 4, 2]}, 0)


def case_squeeze2(rs):
    x = _arr(rs, (2, 1, 3, 1))
    for axes in ([1], [3], [], [0, 1]):
        _check("squeeze2", {"X": [x]}, {"axes": axes}, 0, slots=["Out"])


def case_beam_search(rs):
    # dead beams at NEG and a uniform step: ties everywhere; lax.top_k
    # keeps the lower flat index, and so must the port
    B, K, V = 3, 3, 5
    pre_ids = np.array([[1, 1, 1], [0, 2, 0], [4, 0, 3]], "int32")
    pre_scores = np.array([[0.0, -1e9, -1e9], [-0.5, -0.7, -0.5],
                           [-1.0, -1.0, -1.0]], "float32")
    scores = np.log(np.full((B, K, V), 1.0 / V, "float32"))
    for s in (scores, _arr(rs, (B, K, V))):
        _check("beam_search", {"pre_ids": [pre_ids],
                               "pre_scores": [pre_scores], "scores": [s]},
               {"beam_size": K, "end_id": 0}, 0)


def case_beam_search_decode(rs):
    T, B, K = 4, 2, 3
    _check("beam_search_decode",
           {"Ids": [rs.randint(0, 9, (T, B, K)).astype("int32")],
            "ParentIdx": [rs.randint(0, K, (T, B, K)).astype("int32")],
            "Scores": [_arr(rs, (T, B, K))]}, {}, 0)


def case_beam_gather(rs):
    _check("beam_gather", {"X": [_arr(rs, (6, 4))],
                           "Index": [np.array([[2, 0, 0], [1, 2, 1]],
                                              "int32")]}, {}, 0)


def case_py_func(rs):
    _check("py_func", {"X": [_arr(rs, (2, 3)), _arr(rs, (2, 3))]},
           {"forward_func": lambda a, b: (a * b + 1.0, a.sum(1)),
            "out_shapes": [[2, 3], [2]],
            "out_dtypes": ["float32", "float32"]}, 1e-6)


def _control_flow_case(build, feeds, atol):
    from torch_parity import assert_runs_close, run_both

    jres, tres, _, _ = run_both(build, feeds)
    assert_runs_close(jres, tres, atol)


def case_while(rs):
    def build(pkg):
        L = pkg.layers
        n = L.data("n", [1], append_batch_size=False)
        i = L.fill_constant([1], "float32", 0.0)
        s = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(s, L.elementwise_mul(i, i)), output=s)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), output=cond)
        return [s, i]

    _control_flow_case(build, [{"n": np.array([v], "float32")}
                               for v in (0.0, 1.0, 7.0)], 0)


def case_moe_ffn(rs):
    """The local path, top-2 with overflow and the z-loss: Out and
    AuxLoss (the expert path under a mesh is held in
    test_torch_moe_pipeline.py)."""
    def build(pkg):
        out, aux = pkg.layers.moe_ffn(pkg.layers.data("x", [8]), n_experts=4,
                                      d_hidden=16, capacity=3, top_k=2,
                                      z_loss=1e-2)
        return [out, aux]

    _control_flow_case(build, [{"x": _arr(rs, (12, 8))}], 1e-5)


def case_pipeline(rs):
    """Three stages applied in turn (the sequential fallback; the pipe
    schedule under a mesh is held in test_torch_moe_pipeline.py)."""
    def build(pkg):
        L = pkg.layers

        def stage(pb, h):
            return L.tanh(L.elementwise_add(L.matmul(h, pb.param([8, 8])),
                                            pb.param([8], is_bias=True)))

        return [L.pipeline(L.data("x", [8]), n_stages=3, stage_fn=stage,
                           n_microbatches=2)]

    _control_flow_case(build, [{"x": _arr(rs, (4, 8))}], 1e-5)


def case_conditional_block(rs):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [1], append_batch_size=False)
        out = L.fill_constant([1], "float32", 0.0)
        pred = L.greater_than(x, L.fill_constant([1], "float32", 0.5))
        L.cond(pred,
               true_fn=lambda: L.assign(L.scale(x, 2.0), output=out),
               false_fn=lambda: L.assign(L.scale(x, -3.0), output=out))
        return [out]

    _control_flow_case(build, [{"x": np.array([v], "float32")}
                               for v in (0.9, 0.1)], 0)


def case_recurrent(rs):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4, 3, 2], append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)
            prev = rnn.memory(shape=[-1, 5], batch_ref=word,
                              ref_batch_dim_idx=1)
            h = L.fc([word, prev], size=5, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        return [rnn()]

    _control_flow_case(build, [{"x": _arr(rs, (4, 3, 2))}], 1e-5)


def case_scan_layers(rs):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4])
        return [L.scan_layers(x, 3, lambda h: L.fc(h, size=4, act="tanh"))]

    _control_flow_case(build, [{"x": _arr(rs, (2, 4))}], 1e-5)


# activations: (input maker, attrs); inputs keep clear of kinks and of
# round()'s half-way points
_ACT_INPUTS = {
    "sqrt": lambda x: np.abs(x) + 0.1, "rsqrt": lambda x: np.abs(x) + 0.1,
    "log": lambda x: np.abs(x) + 0.1, "reciprocal": lambda x: np.abs(x) + 0.5,
    "pow": lambda x: np.abs(x) + 0.1,
    "round": lambda x: np.round(x * 3) / 3 + 0.1,
}
_ACT_ATTRS = {
    "gelu": [{}, {"approximate": True}], "pow": [{"factor": 1.5}],
    "leaky_relu": [{"alpha": 0.1}], "elu": [{"alpha": 0.5}],
    "relu6": [{"threshold": 1.0}], "soft_relu": [{"threshold": 2.0}],
    "swish": [{"beta": 1.5}], "brelu": [{"t_min": -1.0, "t_max": 1.0}],
}
ACTIVATIONS = ["sigmoid", "tanh", "sqrt", "rsqrt", "abs", "exp", "log",
               "square", "reciprocal", "softplus", "softsign", "ceil",
               "floor", "round", "cos", "sin", "gelu", "relu6",
               "leaky_relu", "elu", "pow", "stanh", "hard_sigmoid",
               "hard_swish", "swish", "brelu", "soft_relu", "logsigmoid",
               "tanh_shrink", "thresholded_relu", "hard_shrink", "mish",
               "silu"]


def _act_case(op_type):
    def case(rs):
        x = (_arr(rs, (4, 6)) * 3).astype("float32")
        x = _ACT_INPUTS.get(op_type, lambda a: a)(x).astype("float32")
        for attrs in _ACT_ATTRS.get(op_type, [{}]):
            _check(op_type, {"X": [x]}, attrs, 1e-5, rtol=1e-6)

    return case


for _op in ACTIVATIONS:
    globals()["case_" + _op] = _act_case(_op)


# the op tail the port's layers build (tensor, math, basic, nn ops) and
# the loss ops with their interpolation and affine ops: tolerances as in
# the module docstring; the scans (warpctc, linear_chain_crf) atol 1e-5
# plus rtol 1e-6, as the recurrent ops' cases; tests/test_torch_loss.py
# holds their lengths, ties and the random ops further
def case_split(rs):
    x = _arr(rs, (4, 6, 3))
    _check("split", {"X": [x]}, {"axis": 1, "num": 3}, 0)
    _check("split", {"X": [x]}, {"axis": 1, "sections": [1, 2, 3]}, 0)
    _check("split", {"X": [x]}, {"axis": 0, "sections": [3, -1]}, 0)


def case_squeeze(rs):
    _check("squeeze", {"X": [_arr(rs, (2, 1, 3, 1))]}, {"axes": [1]}, 0)
    _check("squeeze", {"X": [_arr(rs, (2, 1, 3, 1))]}, {}, 0)
    _check("squeeze", {"X": [_arr(rs, (2, 1, 3, 1))]}, {"axes": [0, -1]}, 0)


def case_unsqueeze(rs):
    _check("unsqueeze", {"X": [_arr(rs, (2, 3))]}, {"axes": [2, 0]}, 0)


def case_flatten(rs):
    for axis in (0, 1, 2, 3):
        _check("flatten", {"X": [_arr(rs, (2, 3, 4))]}, {"axis": axis}, 0)


def case_flatten2(rs):
    _check("flatten2", {"X": [_arr(rs, (2, 3, 4))]}, {"axis": 2}, 0)


def case_unstack(rs):
    _check("unstack", {"X": [_arr(rs, (2, 3, 4))]}, {"axis": 1}, 0)
    _check("unstack", {"X": [_arr(rs, (2, 3, 4))]}, {}, 0)


def case_strided_slice(rs):
    x = _arr(rs, (7, 6, 5))
    for attrs in ({"axes": [0, 2], "starts": [1, 0], "ends": [6, 5],
                   "strides": [2, 3]},
                  {"axes": [1], "starts": [5], "ends": [0],
                   "strides": [-2]},
                  {"axes": [0, 1], "starts": [-1, -8], "ends": [-8, 9],
                   "strides": [-3, 1]},
                  {"axes": [2], "starts": [4], "ends": [4],
                   "strides": [1]}):
        _check("strided_slice", {"Input": [x]}, attrs, 0)


def case_gather_nd(rs):
    x = _arr(rs, (4, 5, 3))
    _check("gather_nd", {"X": [x], "Index": [np.array(
        [[0, 1], [3, 4], [-1, 2]], "int32")]}, {}, 0)
    _check("gather_nd", {"X": [x], "Index": [np.array(
        [[[1], [2]], [[0], [3]]], "int32")]}, {}, 0)
    # past the end: clamped (JAX's indexing)
    _check("gather_nd", {"X": [x], "Index": [np.array(
        [[9, 1, 7], [-9, 0, 0]], "int32")]}, {}, 0)


def case_scatter(rs):
    x = _arr(rs, (6, 3))
    upd = _arr(rs, (3, 3))
    ids = np.array([4, 0, 2], "int32")  # unique: the winner is defined
    for overwrite in (True, False):
        _check("scatter", {"X": [x], "Ids": [ids], "Updates": [upd]},
               {"overwrite": overwrite}, 1e-6)
        _check("scatter", {"X": [x], "Ids": [ids[:, None]],
                           "Updates": [upd]}, {"overwrite": overwrite}, 1e-6)
    # repeated ids added, an id past the rows dropped, a negative wrapping
    _check("scatter", {"X": [x], "Ids": [np.array([1, 1, 9], "int32")],
                       "Updates": [upd]}, {"overwrite": False}, 1e-6)
    _check("scatter", {"X": [x], "Ids": [np.array([-1, 7, 0], "int32")],
                       "Updates": [upd]}, {"overwrite": True}, 0)


def case_expand_as(rs):
    _check("expand_as", {"X": [_arr(rs, (2, 1, 3))],
                         "target_tensor": [_arr(rs, (4, 5, 3))]}, {}, 0)


def case_tile(rs):
    x = _arr(rs, (2, 3))
    for reps in ([2, 3], [3], [2, 1, 2]):
        _check("tile", {"X": [x]}, {"repeat_times": reps}, 0)


def case_pad(rs):
    _check("pad", {"X": [_arr(rs, (2, 3, 4))]},
           {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": 1.5}, 0)
    _check("pad", {"X": [_arr(rs, (2, 3), "int32")]},
           {"paddings": [1, 1, 0, 2]}, 0)


def case_pad2d(rs):
    x = _arr(rs, (2, 3, 4, 5))
    for mode in ("constant", "reflect", "edge"):
        _check("pad2d", {"X": [x]}, {"paddings": [1, 2, 3, 0], "mode": mode,
                                     "pad_value": -2.0}, 0)


def case_crop(rs):
    _check("crop", {"X": [_arr(rs, (4, 5, 6))]},
           {"offsets": [1, 0, 2], "shape": [2, 5, 3]}, 0)


def case_reverse(rs):
    _check("reverse", {"X": [_arr(rs, (3, 4, 5))]}, {"axis": [0, 2]}, 0)
    _check("reverse", {"X": [_arr(rs, (3, 4, 5))]}, {"axis": [-2]}, 0)


def case_shard_index(rs):
    x = np.array([[0], [7], [12], [19], [5]], "int32")
    for shard in (0, 1, 2):
        _check("shard_index", {"X": [x]},
               {"index_num": 20, "nshards": 3, "shard_id": shard,
                "ignore_value": -1}, 0)


def case_roll(rs):
    x = _arr(rs, (3, 4, 5))
    _check("roll", {"X": [x]}, {"shifts": [1, -2], "axis": [0, 2]}, 0)
    _check("roll", {"X": [x]}, {"shifts": 7}, 0)


def case_meshgrid(rs):
    _check("meshgrid", {"X": [_arr(rs, (3,)), _arr(rs, (4,)),
                              _arr(rs, (2,))]}, {}, 0)


def case_matmul_v2(rs):
    for xs, ys, attrs in (((2, 3, 4), (4, 5), {}),
                          ((2, 4, 3), (2, 5, 4), {"trans_x": True,
                                                  "trans_y": True}),
                          ((3, 4), (2, 4, 5), {}),
                          ((4,), (4, 5), {})):
        _check("matmul_v2", {"X": [_arr(rs, xs)], "Y": [_arr(rs, ys)]},
               attrs, 1e-5)


def case_bmm(rs):
    _check("bmm", {"X": [_arr(rs, (3, 2, 4))], "Y": [_arr(rs, (3, 4, 5))]},
           {}, 1e-5)


def _tied(rs):
    return rs.randint(0, 3, (4, 6)).astype("float32")  # many ties


def case_arg_max(rs):
    for axis in (-1, 0):
        _check("arg_max", {"X": [_tied(rs)]}, {"axis": axis}, 0)


def case_arg_min(rs):
    for axis in (-1, 0):
        _check("arg_min", {"X": [_tied(rs)]}, {"axis": axis}, 0)


def case_argsort(rs):
    for axis in (-1, 0):
        _check("argsort", {"X": [_tied(rs)]}, {"axis": axis}, 0)
    _check("argsort", {"X": [_arr(rs, (3, 7))]}, {}, 0)


def case_cumsum(rs):
    x = _arr(rs, (3, 5))
    for attrs in ({}, {"axis": 0}, {"exclusive": True}, {"reverse": True},
                  {"exclusive": True, "reverse": True, "axis": 0},
                  {"flatten": True}):
        _check("cumsum", {"X": [x]}, attrs, 1e-6)
    _check("cumsum", {"X": [_arr(rs, (3, 5), "int32")]}, {"axis": 1}, 0)


def case_norm(rs):
    _check("norm", {"X": [_arr(rs, (3, 4, 5))]}, {"axis": 1}, 1e-6)
    _check("norm", {"X": [_arr(rs, (3, 4))]}, {"epsilon": 1e-3}, 1e-6)


def case_dot(rs):
    _check("dot", {"X": [_arr(rs, (3, 5))], "Y": [_arr(rs, (3, 5))]}, {},
           1e-5)


def case_maximum_with_index(rs):
    _check("maximum_with_index", {"X": [_tied(rs)]}, {}, 0)


def case_fill_any_like(rs):
    x = _arr(rs, (2, 3))
    _check("fill_any_like", {"X": [x]}, {"value": 2.5}, 0)
    _check("fill_any_like", {"X": [x]}, {"value": 3, "dtype": "int32"}, 0)


def _draws(op_type, attrs, chain_seed, ins=None):
    ctx = LowerContext(None, torch.Generator().manual_seed(chain_seed), CPU)
    return get_op(op_type).lowering(ctx, ins or {}, dict(attrs))["Out"][0]


def _jax_draw(op_type, attrs, ins=None):
    import jax
    import jax.numpy as jnp

    return np.asarray(jax_op(op_type).lowering(
        JaxContext(None, jax.random.PRNGKey(0)),
        {k: [jnp.asarray(v) for v in vs] for k, vs in (ins or {}).items()},
        dict(attrs))["Out"][0])


def case_truncated_gaussian_random(rs):
    """Another generator than the JAX package's: shape, dtype, the
    truncation and the moments of both, the seeds within the port."""
    attrs = {"shape": [128, 128], "mean": 0.5, "std": 2.0, "seed": 0,
             "dtype": "float32"}
    want = _jax_draw("truncated_gaussian_random", attrs)
    a = _draws("truncated_gaussian_random", attrs, 3)
    assert tuple(a.shape) == want.shape and a.dtype == torch.float32
    # N(0, 1) truncated to [-2, 2] has std 0.8796; 16384 draws: within
    # 5 standard errors
    for got in (a.numpy(), want):
        assert got.min() >= 0.5 - 4.0 and got.max() <= 0.5 + 4.0
        assert abs(got.mean() - 0.5) < 5 * 2 * 0.8796 / 128
        assert abs(got.std() - 2 * 0.8796) < 5 * 2.0 / np.sqrt(2 * 16384)
    torch.testing.assert_close(
        _draws("truncated_gaussian_random", attrs, 3), a, rtol=0, atol=0)
    assert not torch.equal(_draws("truncated_gaussian_random", attrs, 4), a)
    fixed = dict(attrs, seed=9)
    torch.testing.assert_close(
        _draws("truncated_gaussian_random", fixed, 3),
        _draws("truncated_gaussian_random", fixed, 4), rtol=0, atol=0)


def case_uniform_random_batch_size_like(rs):
    ins = {"Input": [_arr(rs, (3, 7))]}
    attrs = {"shape": [-1, 200], "input_dim_idx": 1, "output_dim_idx": 0,
             "min": -0.5, "max": 2.0, "dtype": "float32"}
    want = _jax_draw("uniform_random_batch_size_like", attrs, ins)
    t_ins = {"Input": [torch.from_numpy(ins["Input"][0])]}
    a = _draws("uniform_random_batch_size_like", attrs, 3, t_ins)
    assert tuple(a.shape) == want.shape == (7, 200)
    for got in (a.numpy(), want):
        assert got.min() >= -0.5 and got.max() < 2.0
        assert got.max() - got.min() > 2.3
    torch.testing.assert_close(
        _draws("uniform_random_batch_size_like", attrs, 3, t_ins), a,
        rtol=0, atol=0)
    assert not torch.equal(
        _draws("uniform_random_batch_size_like", attrs, 4, t_ins), a)


def case_share_data(rs):
    _check("share_data", {"X": [_arr(rs, (2, 3))]}, {}, 0)


def case_shape(rs):
    _check("shape", {"Input": [_arr(rs, (2, 3, 5))]}, {}, 0)


def case_isfinite(rs):
    x = _arr(rs, (3, 4))
    _check("isfinite", {"X": [x]}, {}, 0)
    for bad in (np.nan, np.inf, -np.inf):
        y = x.copy()
        y[1, 2] = bad
        _check("isfinite", {"X": [y]}, {}, 0)


def case_linspace(rs):
    """0-d bounds: the JAX package's ``float(start)`` refuses the [1]
    tensors the layer builds (this JAX raises on a 1-d array), which the
    port reads as well (tests/test_torch_loss.py runs the layer)."""
    for start, stop, num in ((0.0, 1.0, 5), (-3.5, 2.25, 11), (2.0, 2.0, 1),
                             (1.0, -1.0, 4)):
        _check("linspace", {"Start": [np.array(start, "float32")],
                            "Stop": [np.array(stop, "float32")],
                            "Num": [np.array(num, "int32")]}, {}, 1e-6)


def case_sampling_id(rs):
    p = rs.rand(4000, 3).astype("float32") * [1.0, 0.0, 3.0]
    p = (p / p.sum(1, keepdims=True)).astype("float32")
    ins = {"X": [p]}
    want = _jax_draw("sampling_id", {"seed": 0}, ins)
    t_ins = {"X": [torch.from_numpy(p)]}
    a = _draws("sampling_id", {"seed": 0}, 3, t_ins)
    assert a.dtype == torch.int32 and tuple(a.shape) == want.shape
    # a zero-probability id is never drawn; each row's expected share
    # within 5 standard errors, in both packages
    expect = p.mean(0)
    for got in (a.numpy(), want):
        assert not (got == 1).any()
        share = np.bincount(got, minlength=3) / len(got)
        assert np.all(np.abs(share - expect) < 5 * np.sqrt(0.25 / 4000))
    torch.testing.assert_close(_draws("sampling_id", {}, 3, t_ins), a,
                               rtol=0, atol=0)
    torch.testing.assert_close(_draws("sampling_id", {"seed": 7}, 3, t_ins),
                               _draws("sampling_id", {"seed": 7}, 4, t_ins),
                               rtol=0, atol=0)


def case_prelu(rs):
    x = _arr(rs, (2, 3, 4, 5))
    _check("prelu", {"X": [x], "Alpha": [np.array([0.25], "float32")]},
           {"mode": "all"}, 1e-6)
    _check("prelu", {"X": [x], "Alpha": [_arr(rs, (3,))]},
           {"mode": "channel"}, 1e-6)
    _check("prelu", {"X": [x], "Alpha": [_arr(rs, (1, 3, 1, 1))]},
           {"mode": "channel"}, 1e-6)
    _check("prelu", {"X": [x], "Alpha": [_arr(rs, (1, 3, 4, 5))]},
           {"mode": "element"}, 1e-6)


def case_depthwise_conv2d(rs):
    x = _arr(rs, (2, 4, 9, 8))
    _check("depthwise_conv2d", {"Input": [x], "Filter": [_arr(rs, (4, 1, 3,
                                                                   3))]},
           {"strides": [1, 2], "paddings": [1, 1]}, 1e-5)
    _check("depthwise_conv2d", {"Input": [x], "Filter": [_arr(rs, (8, 1, 3,
                                                                   2))]},
           {"strides": [2, 1], "paddings": [0, 1], "dilations": [2, 1],
            "groups": 4}, 1e-5)


def case_conv2d_transpose(rs):
    x = _arr(rs, (2, 4, 5, 6))
    for w_shape, attrs in (((4, 3, 3, 3), {}),
                           ((4, 2, 3, 2), {"strides": [2, 1],
                                           "paddings": [1, 0]}),
                           ((4, 3, 2, 3), {"strides": [2, 3],
                                           "paddings": [0, 1],
                                           "dilations": [2, 1]})):
        _check("conv2d_transpose", {"Input": [x], "Filter": [_arr(rs,
                                                                  w_shape)]},
               attrs, 1e-5)


def case_conv3d(rs):
    x = _arr(rs, (2, 4, 5, 6, 5))
    _check("conv3d", {"Input": [x], "Filter": [_arr(rs, (3, 4, 3, 3, 2))]},
           {"strides": [1, 2, 1], "paddings": [1, 0, 1]}, 1e-5)
    _check("conv3d", {"Input": [x], "Filter": [_arr(rs, (4, 2, 2, 3, 3))]},
           {"dilations": [2, 1, 1], "groups": 2}, 1e-5)


def _pool_mask(x, k, s, p):
    """Fluid's max-pool mask: the flat H * W index of each window's
    first max (numpy loops)."""
    n, c, H, W = x.shape
    oh = (H + 2 * p[0] - k[0]) // s[0] + 1
    ow = (W + 2 * p[1] - k[1]) // s[1] + 1
    out = np.zeros((n, c, oh, ow), "int32")
    for i in range(oh):
        for j in range(ow):
            best, at = -np.inf, -1
            for a in range(i * s[0] - p[0], i * s[0] - p[0] + k[0]):
                for b in range(j * s[1] - p[1], j * s[1] - p[1] + k[1]):
                    if 0 <= a < H and 0 <= b < W:
                        v = x[:, :, a, b]
                        upd = v > best
                        at = np.where(upd, a * W + b, at)
                        best = np.where(upd, v, best)
            out[:, :, i, j] = at
    return out


def case_pool2d_with_index(rs):
    """Out against the JAX package; Mask (which the JAX package leaves
    at 0) against Fluid's rule, ties included."""
    x = rs.randint(0, 3, (2, 3, 7, 6)).astype("float32")
    for k, s, p in (((3, 3), (2, 2), (1, 1)), ((2, 2), (2, 2), (0, 0)),
                    ((3, 2), (1, 2), (1, 0))):
        attrs = {"ksize": list(k), "strides": list(s), "paddings": list(p)}
        _check("pool2d_with_index", {"X": [x]}, attrs, 0, slots=["Out"])
        _, t = _run_both("pool2d_with_index", {"X": [x]}, attrs)
        np.testing.assert_array_equal(t["Mask"][0], _pool_mask(x, k, s, p))


def case_group_norm(rs):
    x = _arr(rs, (2, 6, 3, 4)) * 2 + 1
    _check("group_norm", {"X": [x], "Scale": [_arr(rs, (6,))],
                          "Bias": [_arr(rs, (6,))]},
           {"groups": 3, "epsilon": 1e-5}, 1e-5)
    _check("group_norm", {"X": [x]}, {"groups": 2}, 1e-5)


def case_lrn(rs):
    _check("lrn", {"X": [_arr(rs, (2, 7, 3, 4))]}, {}, 1e-5)
    _check("lrn", {"X": [_arr(rs, (2, 4, 3, 3))]},
           {"n": 3, "k": 1.0, "alpha": 0.1, "beta": 0.5}, 1e-5)


def case_log_softmax(rs):
    _check("log_softmax", {"X": [_arr(rs, (3, 4, 5)) * 3]}, {}, 1e-5)
    _check("log_softmax", {"X": [_arr(rs, (3, 4, 5)) * 3]}, {"axis": 1},
           1e-5)


def case_sigmoid_cross_entropy_with_logits(rs):
    x = _arr(rs, (4, 5)) * 4
    label = rs.rand(4, 5).astype("float32")
    label[0, 1] = label[2, 3] = -100.0
    for attrs in ({}, {"normalize": True}, {"ignore_index": -1}):
        _check("sigmoid_cross_entropy_with_logits",
               {"X": [x], "Label": [label]}, attrs, 1e-5, rtol=1e-6)


def case_square_error_cost(rs):
    _check("square_error_cost", {"X": [_arr(rs, (4, 3))],
                                 "Y": [_arr(rs, (4, 3))]}, {}, 1e-6)


def case_smooth_l1_loss(rs):
    """The JAX package reads no InsideWeight / OutsideWeight (no layer
    passes them); with them the port's Out follows Fluid's formula."""
    x, y = _arr(rs, (4, 3, 2)), _arr(rs, (4, 3, 2))
    for sigma in (1.0, 3.0):
        _check("smooth_l1_loss", {"X": [x], "Y": [y]}, {"sigma": sigma},
               1e-5)
    inside, outside = rs.rand(4, 3, 2).astype("float32"), \
        rs.rand(4, 3, 2).astype("float32")
    t = get_op("smooth_l1_loss").lowering(
        LowerContext(None, None, CPU),
        {k: [torch.from_numpy(v)] for k, v in (
            ("X", x), ("Y", y), ("InsideWeight", inside),
            ("OutsideWeight", outside))}, {"sigma": 2.0})
    d = (x - y) * inside
    ad = np.abs(d)
    want = (np.where(ad < 0.25, 2.0 * d * d, ad - 0.125) * outside).sum(
        (1, 2)).reshape(-1, 1)
    np.testing.assert_allclose(t["Diff"][0].numpy(), d, atol=1e-6)
    np.testing.assert_allclose(t["Out"][0].numpy(), want, atol=1e-5)


def case_huber_loss(rs):
    for delta in (1.0, 0.3):
        _check("huber_loss", {"X": [_arr(rs, (5, 1))],
                              "Y": [_arr(rs, (5, 1))]}, {"delta": delta},
               1e-6)


def case_log_loss(rs):
    p = rs.rand(6, 1).astype("float32")
    label = rs.randint(0, 2, (6, 1)).astype("float32")
    _check("log_loss", {"Predicted": [p], "Labels": [label]},
           {"epsilon": 1e-4}, 1e-5)


def case_lookup_table_v2(rs):
    w = _arr(rs, (10, 4))
    _check("lookup_table_v2", {"W": [w], "Ids": [_arr(rs, (2, 3),
                                                      "int32")]},
           {"padding_idx": -1}, 0)
    _check("lookup_table_v2", {"W": [w], "Ids": [np.array(
        [[1], [2], [12]], "int32")]}, {"padding_idx": 2}, 0)


def case_maxout(rs):
    _check("maxout", {"X": [_arr(rs, (2, 6, 3, 4))]}, {"groups": 3}, 0)
    _check("maxout", {"X": [_tied(rs).reshape(2, 4, 3)]}, {"groups": 2}, 0)


def case_im2sequence(rs):
    """Unsupported in both packages: the same error."""
    for lowering, ctx, x in (
            (jax_op("im2sequence").lowering, JaxContext(None, None),
             np.zeros((1, 1, 4, 4), "float32")),
            (get_op("im2sequence").lowering, LowerContext(None, None, CPU),
             torch.zeros(1, 1, 4, 4))):
        with pytest.raises(NotImplementedError,
                           match="im2sequence is not supported"):
            lowering(ctx, {"X": [x]}, {"kernels": [2, 2]})


def case_cos_sim(rs):
    x = _arr(rs, (4, 6))
    _check("cos_sim", {"X": [x], "Y": [_arr(rs, (4, 6))]}, {}, 1e-6)
    _check("cos_sim", {"X": [x], "Y": [_arr(rs, (1, 6))]}, {}, 1e-6)
    _check("cos_sim", {"X": [x], "Y": [np.zeros((1, 6), "float32")]}, {},
           1e-6)


def case_rank_loss(rs):
    _check("rank_loss", {"Label": [rs.randint(0, 2, (5, 1)).astype(
        "float32")], "Left": [_arr(rs, (5, 1)) * 3],
        "Right": [_arr(rs, (5, 1))]}, {}, 1e-6)


def case_margin_rank_loss(rs):
    _check("margin_rank_loss", {
        "Label": [np.array([[1], [-1], [1], [-1]], "float32")],
        "X1": [_arr(rs, (4, 1))], "X2": [_arr(rs, (4, 1))]},
        {"margin": 0.3}, 1e-6)


def case_bpr_loss(rs):
    _check("bpr_loss", {"X": [_arr(rs, (5, 7)) * 2],
                        "Label": [np.array([[0], [6], [3], [3], [1]],
                                           "int32")]}, {}, 1e-5)


def case_nce(rs):
    """The negatives are drawn by another generator than the JAX
    package's: the JAX package's loss (``_nce_loss``) of the port's
    SampleLabels."""
    from paddle_tpu.ops.loss_ops import _nce_loss

    x, w, b = _arr(rs, (4, 6)), _arr(rs, (12, 6)), _arr(rs, (12,))
    label = np.array([[3], [0], [11], [3]], "int32")
    for bias in (True, False):
        ins = {"Input": [x], "Weight": [w], "Label": [label]}
        if bias:
            ins["Bias"] = [b]
        attrs = {"num_neg_samples": 5, "num_total_classes": 12}
        t = _draws_all("nce", attrs, 3, ins)
        ids = t["SampleLabels"][0].numpy()
        assert ids.dtype == np.int32 and ids.shape == (4, 6)
        np.testing.assert_array_equal(ids[:, 0], label[:, 0])
        assert ((ids >= 0) & (ids < 12)).all()
        cost, logits = _nce_loss(x, w, b if bias else None, ids, 5, 12)
        np.testing.assert_allclose(t["Cost"][0].numpy(), np.asarray(cost),
                                   atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(t["SampleLogits"][0].numpy(),
                                   np.asarray(logits), atol=1e-5, rtol=1e-6)


def _draws_all(op_type, attrs, chain_seed, ins):
    ctx = LowerContext(None, torch.Generator().manual_seed(chain_seed), CPU)
    return get_op(op_type).lowering(
        ctx, {k: [torch.from_numpy(np.array(v)) for v in vs]
              for k, vs in ins.items()}, dict(attrs))


def case_hierarchical_sigmoid(rs):
    x = _arr(rs, (6, 5))
    label = np.array([[0], [1], [6], [3], [2], [5]], "int32")
    for C in (7, 8, 2):
        ins = {"X": [x], "W": [_arr(rs, (C - 1, 5))],
               "Label": [label % C]}
        _check("hierarchical_sigmoid", ins, {"num_classes": C}, 1e-5,
               slots=["Out"])
        ins["Bias"] = [_arr(rs, (C - 1,))]
        _check("hierarchical_sigmoid", ins, {"num_classes": C}, 1e-5,
               slots=["Out"])


LOSS_LENGTHS = np.array([0, 1, 6, 3], "int32")


def case_warpctc(rs):
    logits = _arr(rs, (4, 6, 5)) * 2
    label = rs.randint(1, 5, (4, 3)).astype("int32")
    label[2] = [2, 2, 3]  # a repeat needs a blank between
    for blank, lab_len, log_len in (
            (0, [0, 1, 3, 2], [1, 2, 6, 4]),
            (4, [2, 3, 3, 1], [6, 6, 6, 1])):
        lab = np.where(label == blank, 1, label).astype("int32")
        _check("warpctc", {"Logits": [logits], "Label": [lab],
                           "LogitsLength": [np.array(log_len, "int32")],
                           "LabelLength": [np.array(lab_len, "int32")]},
               {"blank": blank, "norm_by_times": False}, 1e-5, rtol=1e-6)


def _crf_ins(rs, C=4):
    emission = _arr(rs, (4, 6, C))
    transition = _arr(rs, (C + 2, C)) * 0.5
    label = rs.randint(0, C, (4, 6)).astype("int32")
    return emission, transition, label


def case_linear_chain_crf(rs):
    emission, transition, label = _crf_ins(rs)
    _check("linear_chain_crf", {"Emission": [emission],
                                "Transition": [transition],
                                "Label": [label],
                                "Length": [LOSS_LENGTHS]}, {}, 1e-5,
           rtol=1e-6, slots=["LogLikelihood"])


def case_crf_decoding(rs):
    emission, transition, _ = _crf_ins(rs)
    _check("crf_decoding", {"Emission": [emission],
                            "Transition": [transition],
                            "Length": [LOSS_LENGTHS]}, {}, 0)
    # integer scores: ties at every step, the first index wins
    _check("crf_decoding", {"Emission": [np.round(emission)],
                            "Transition": [np.round(transition)],
                            "Length": [LOSS_LENGTHS]}, {}, 0)


def case_edit_distance(rs):
    hyp = rs.randint(0, 4, (4, 5)).astype("int32")
    ref = rs.randint(0, 4, (4, 6)).astype("int32")
    for normalized in (False, True):
        _check("edit_distance", {
            "Hyps": [hyp], "Refs": [ref],
            "HypsLength": [np.array([5, 0, 3, 1], "int32")],
            "RefsLength": [np.array([6, 2, 0, 4], "int32")]},
            {"normalized": normalized}, 1e-6)


def case_bilinear_interp(rs):
    x = _arr(rs, (2, 3, 4, 5))
    for attrs in ({"out_h": 7, "out_w": 3}, {"out_h": 1, "out_w": 8},
                  {"out_h": 6, "out_w": 9, "align_corners": False},
                  {"scale": 1.5}, {"scale": 0.5, "align_corners": False}):
        _check("bilinear_interp", {"X": [x]}, attrs, 1e-6)


def case_nearest_interp(rs):
    x = _arr(rs, (2, 3, 4, 5))
    for attrs in ({"out_h": 7, "out_w": 3}, {"out_h": 1, "out_w": 8},
                  {"out_h": 6, "out_w": 9, "align_corners": False},
                  {"scale": 2.0}, {"out_h": 3, "out_w": 4,
                                   "align_corners": False}):
        _check("nearest_interp", {"X": [x]}, attrs, 0)


def case_affine_channel(rs):
    _check("affine_channel", {"X": [_arr(rs, (2, 3, 4, 5))],
                              "Scale": [_arr(rs, (3,))],
                              "Bias": [_arr(rs, (3,))]}, {}, 1e-6)
    _check("affine_channel", {"X": [_arr(rs, (2, 3))],
                              "Scale": [_arr(rs, (3,))],
                              "Bias": [_arr(rs, (3,))]}, {}, 1e-6)


# ------------------------------------------- misc_ops' tail and quant_ops
def case_selu(rs):
    _check("selu", {"X": [_arr(rs, (3, 5)) * 3]}, {}, 1e-5, rtol=1e-6)
    _check("selu", {"X": [_arr(rs, (4,))]}, {"scale": 1.5, "alpha": 0.5},
           1e-5, rtol=1e-6)


def case_multiplex(rs):
    xs = [_arr(rs, (4, 3)) for _ in range(3)]
    _check("multiplex", {"X": xs,
                         "Ids": [np.array([[2], [0], [1], [2]], "int32")]},
           {}, 0)


def case_space_to_depth(rs):
    _check("space_to_depth", {"X": [_arr(rs, (2, 3, 4, 6))]},
           {"blocksize": 2}, 0)


def case_shuffle_channel(rs):
    _check("shuffle_channel", {"X": [_arr(rs, (2, 6, 3, 2))]}, {"group": 3},
           0)


def case_pad_constant_like(rs):
    _check("pad_constant_like", {"X": [_arr(rs, (4, 5, 3))],
                                 "Y": [_arr(rs, (2, 5, 1))]},
           {"pad_value": 1.5}, 0)


def case_dice_loss_op(rs):
    x = np.abs(_arr(rs, (4, 6, 3)))
    label = rs.randint(0, 3, (4, 6, 1)).astype("int32")
    _check("dice_loss_op", {"X": [x], "Label": [label]}, {"epsilon": 1e-5},
           1e-6)


def case_mean_iou(rs):
    pred = rs.randint(0, 5, (6, 7)).astype("int32")
    label = rs.randint(0, 5, (6, 7)).astype("int32")
    _check("mean_iou", {"Predictions": [pred], "Labels": [label]},
           {"num_classes": 6}, 1e-6)


def case_add_position_encoding(rs):
    _check("add_position_encoding", {"X": [_arr(rs, (2, 7, 8))]},
           {"alpha": 0.5, "beta": 2.0}, 1e-5)


def case_bilinear_tensor_product(rs):
    ins = {"X": [_arr(rs, (3, 4))], "Y": [_arr(rs, (3, 5))],
           "Weight": [_arr(rs, (6, 4, 5))], "Bias": [_arr(rs, (1, 6))]}
    _check("bilinear_tensor_product", ins, {}, 1e-5)
    del ins["Bias"]
    _check("bilinear_tensor_product", ins, {}, 1e-5)


def case_teacher_student_sigmoid_loss(rs):
    label = np.array([[-2.0], [-1.0], [0.3], [0.0], [1.0], [1.7]],
                     "float32")
    _check("teacher_student_sigmoid_loss",
           {"X": [_arr(rs, (6, 1)) * 3], "Label": [label]}, {}, 1e-6)


def case_npair_loss_op(rs):
    _check("npair_loss_op", {"Anchor": [_arr(rs, (5, 4))],
                             "Positive": [_arr(rs, (5, 4))],
                             "Labels": [np.array([1, 2, 1, 3, 2], "int32")]},
           {"l2_reg": 0.002}, 1e-5)


def case_gaussian_random_batch_size_like(rs):
    """Another generator than the JAX package's: shape, dtype and the
    moments of both, the seeds within the port."""
    ins = {"Input": [_arr(rs, (3, 7))]}
    attrs = {"shape": [-1, 400], "input_dim_idx": 1, "output_dim_idx": 0,
             "mean": 0.5, "std": 2.0, "dtype": "float32"}
    want = _jax_draw("gaussian_random_batch_size_like", attrs, ins)
    t_ins = {"Input": [torch.from_numpy(ins["Input"][0])]}
    a = _draws("gaussian_random_batch_size_like", attrs, 3, t_ins)
    assert tuple(a.shape) == want.shape == (7, 400)
    assert a.dtype == torch.float32 and want.dtype == np.float32
    for got in (a.numpy(), want):  # 2800 draws: within 5 standard errors
        assert abs(got.mean() - 0.5) < 5 * 2.0 / np.sqrt(2800)
        assert abs(got.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * 2800)
    torch.testing.assert_close(
        _draws("gaussian_random_batch_size_like", attrs, 3, t_ins), a,
        rtol=0, atol=0)
    assert not torch.equal(
        _draws("gaussian_random_batch_size_like", attrs, 4, t_ins), a)


def case_random_crop(rs):
    """The crop is a window of the input at offsets within its slack, the
    same window for every example (as the JAX lowering crops); the same
    chain seed crops the same window, the offsets vary with the seed."""
    x = np.arange(2 * 3 * 9 * 8, dtype="float32").reshape(2, 3, 9, 8)
    attrs = {"shape": [4, 5]}
    want = _jax_draw("random_crop", attrs, {"X": [x]})
    assert want.shape == (2, 3, 4, 5)
    offsets = set()
    for seed in range(12):
        got = _draws("random_crop", attrs, seed,
                     {"X": [torch.from_numpy(x)]}).numpy()
        assert got.shape == want.shape
        h0, w0 = divmod(int(got[0, 0, 0, 0]), 8)
        assert 0 <= h0 <= 5 and 0 <= w0 <= 3
        np.testing.assert_array_equal(got, x[:, :, h0:h0 + 4, w0:w0 + 5])
        offsets.add((h0, w0))
        np.testing.assert_array_equal(
            _draws("random_crop", attrs, seed,
                   {"X": [torch.from_numpy(x)]}).numpy(), got)
    assert len(offsets) > 3


def case_increment_counter(rs):
    _check("increment_counter", {"X": [np.array([5], "int32")]},
           {"step": 3}, 0)
    _check("increment_counter", {"X": [np.array([2.5], "float32")]}, {}, 0)


def case_pool3d(rs):
    x = _arr(rs, (2, 3, 5, 6, 4))
    for attrs in ({"pooling_type": "max", "ksize": [2, 3, 2],
                   "strides": [1, 2, 1], "paddings": [1, 1, 0]},
                  {"pooling_type": "avg", "ksize": [2, 2, 2],
                   "strides": [2, 2, 2], "paddings": [0, 0, 0]},
                  {"pooling_type": "avg", "ksize": [3, 3, 3],
                   "strides": [1, 1, 1], "paddings": [1, 1, 1]},
                  {"pooling_type": "avg", "ksize": [3, 3, 3],
                   "strides": [1, 1, 1], "paddings": [1, 1, 1],
                   "exclusive": False},
                  {"pooling_type": "max", "global_pooling": True}):
        _check("pool3d", {"X": [x]}, attrs, 1e-6)


def case_adaptive_pool3d(rs):
    x = _arr(rs, (2, 3, 4, 6, 4))
    for ptype in ("max", "avg"):
        _check("adaptive_pool3d", {"X": [x]},
               {"ksize": [2, 3, 2], "pooling_type": ptype}, 1e-6)


def case_conv3d_transpose(rs):
    x = _arr(rs, (2, 3, 4, 5, 3))
    w = _arr(rs, (3, 4, 3, 2, 3))
    for attrs in ({"strides": [1, 1, 1], "paddings": [0, 0, 0]},
                  {"strides": [2, 1, 2], "paddings": [1, 0, 1]}):
        _check("conv3d_transpose", {"Input": [x], "Filter": [w]}, attrs,
               1e-5)


def case_ctc_greedy_decoder(rs):
    probs = rs.rand(3, 7, 4).astype("float32")
    probs[0, 1:3] = probs[0, 0]           # repeats collapse
    length = np.array([7, 4, 0], "int32")
    _check("ctc_greedy_decoder", {"Input": [probs], "Length": [length]},
           {"blank": 0}, 0)
    _check("ctc_greedy_decoder", {"Input": [probs]}, {"blank": 2}, 0)


def case_spectral_norm(rs):
    w = _arr(rs, (4, 3, 2))
    for ins, attrs in (({"Weight": [w]}, {"dim": 0, "power_iters": 3}),
                       ({"Weight": [w], "U": [_arr(rs, (3,))]},
                        {"dim": 1, "power_iters": 1})):
        _check("spectral_norm", ins, attrs, 1e-5)


def case_affine_grid(rs):
    _check("affine_grid", {"Theta": [_arr(rs, (2, 2, 3))]},
           {"output_shape": [2, 3, 4, 5]}, 1e-6)


def case_grid_sampler(rs):
    x = _arr(rs, (2, 3, 5, 4))
    grid = (rs.rand(2, 3, 6, 2) * 2.4 - 1.2).astype("float32")
    _check("grid_sampler", {"X": [x], "Grid": [grid]}, {}, 1e-5)


def case_sequence_scatter(rs):
    x = _arr(rs, (3, 6))
    ids = np.array([[0, 2, 2, 5], [1, 1, 1, 1], [5, 4, 0, 3]], "int32")
    upd = _arr(rs, (3, 4))
    _check("sequence_scatter", {"X": [x], "Ids": [ids], "Updates": [upd],
                                "Length": [np.array([4, 2, 0], "int32")]},
           {}, 1e-6)
    _check("sequence_scatter", {"X": [x], "Ids": [ids], "Updates": [upd]},
           {}, 1e-6)


def case_data_norm(rs):
    ins = {"X": [_arr(rs, (4, 3))],
           "BatchSize": [np.full((3,), 10.0, "float32")],
           "BatchSum": [_arr(rs, (3,))],
           "BatchSquareSum": [np.abs(_arr(rs, (3,))) * 20 + 10]}
    _check("data_norm", ins, {"epsilon": 1e-4}, 1e-5)


def case_sampled_softmax_with_cross_entropy(rs):
    """The negatives come from another generator than the JAX package's:
    the loss's shape and dtype, and a property: with every logit equal
    the loss is log(1 + S * (S / V)^-1 ... ) over the classes not hit,
    here checked as the softmax CE of the corrected row; the same chain
    seed draws the same loss."""
    logits = np.zeros((4, 50), "float32")
    label = np.array([[1], [7], [0], [49]], "int32")
    attrs = {"num_samples": 10}
    ins = {"Logits": [logits], "Label": [label]}
    import jax
    import jax.numpy as jnp

    want = np.asarray(jax_op("sampled_softmax_with_cross_entropy").lowering(
        JaxContext(None, jax.random.PRNGKey(0)),
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))["Loss"][0])
    got = _draws_all("sampled_softmax_with_cross_entropy", attrs, 3,
                     ins)["Loss"][0].numpy()
    assert got.shape == want.shape == (4, 1) and got.dtype == want.dtype
    # equal logits: the true class scores 0, each kept negative
    # -log(S / V); a hit negative drops out. So the loss lies between
    # log(1 + S * V / S) (no hits) and 0 (all hits)
    top = np.log1p(50.0)
    for v in (got, want):
        assert (v >= -1e-6).all() and (v <= top + 1e-5).all()
    again = _draws_all("sampled_softmax_with_cross_entropy", attrs, 3,
                       ins)["Loss"][0].numpy()
    assert again.tobytes() == got.tobytes()


def case_hash_op(rs):
    """Bitwise the JAX package's mixer (its uint32 arithmetic, here in
    int64 masked to 32 bits), negative ids and ids past int32's range
    included."""
    ids = rs.randint(-2 ** 31, 2 ** 31 - 1, (5, 4)).astype("int32")
    ids[0, :3] = [0, -1, 2 ** 31 - 1]
    for num_hash, mod_by in ((1, 100000), (2, 7), (2, 2 ** 31 - 1)):
        _check("hash_op", {"X": [ids]},
               {"num_hash": num_hash, "mod_by": mod_by}, 0)


def case_psroi_pool(rs):
    x = _arr(rs, (2, 2 * 2 * 3, 6, 7))
    rois = np.array([[0.5, 1.0, 5.0, 4.5], [2.0, 0.0, 6.5, 5.5],
                     [1.0, 1.0, 1.2, 1.1]], "float32")
    for batch in (None, np.array([1, 0, 1], "int32")):
        ins = {"X": [x], "ROIs": [rois]}
        if batch is not None:
            ins["RoisBatch"] = [batch]
        _check("psroi_pool", ins, {"pooled_height": 2, "pooled_width": 3,
                                   "output_channels": 2,
                                   "spatial_scale": 0.9}, 1e-5)


def case_take_along_axis1(rs):
    x = _arr(rs, (2, 5, 3))
    idx = np.array([[0, 4, 4, -1], [2, 1, 0, 3]], "int32")
    _check("take_along_axis1", {"X": [x], "Index": [idx]}, {}, 0)
    _check("take_along_axis1", {"X": [_arr(rs, (3, 6))],
                                "Index": [np.array([[5], [0], [2]],
                                                   "int32")]}, {}, 0)


def case_similarity_focus(rs):
    x = _arr(rs, (2, 3, 4, 5))
    _check("similarity_focus", {"X": [x]}, {"axis": 1, "indexes": [0, 2]},
           0)


def case_roi_perspective_transform(rs):
    x = _arr(rs, (2, 3, 8, 9))
    rois = np.array([[1, 1, 6, 1.5, 6.5, 6, 0.5, 5.5],
                     [0, 0, 8, 0, 8, 7, 0, 7],
                     [2, 3, 4, 2, 5, 5, 2.5, 6]], "float32")
    _check("roi_perspective_transform",
           {"X": [x], "ROIs": [rois],
            "RoisBatch": [np.array([0, 1, 1], "int32")]},
           {"transformed_height": 3, "transformed_width": 4,
            "spatial_scale": 1.0}, 1e-4)


def case_generate_mask_labels(rs):
    rois = np.array([[[0, 0, 8, 8], [2, 2, 6, 7], [1, 0, 3, 9]],
                     [[4, 4, 9, 9], [0, 5, 4, 9], [0, 0, 1, 1]]], "float32")
    labels = np.array([[1, 0, 2], [3, 1, 0]], "int32")
    gt = np.array([[[0, 0, 7, 7], [2, 2, 6, 8]],
                   [[5, 5, 9, 9], [0, 0, 0, 0]]], "float32")
    segms = (rs.rand(2, 2, 10, 10) > 0.5).astype("float32")
    _check("generate_mask_labels",
           {"Rois": [rois], "LabelsInt32": [labels], "GtBoxes": [gt],
            "GtSegms": [segms]}, {"resolution": 4}, 0)


def case_tree_conv(rs):
    nodes = _arr(rs, (2, 5, 3))
    edges = np.array([[[1, 2], [1, 3], [2, 4], [0, 0]],
                      [[0, 1], [0, 2], [0, 3], [3, 4]]], "int32")
    _check("tree_conv", {"NodesVector": [nodes], "EdgeSet": [edges],
                         "Filter": [_arr(rs, (3, 3, 2, 4))]}, {}, 1e-5)


def case_fake_quantize_abs_max(rs):
    x = _arr(rs, (4, 6))
    _check("fake_quantize_abs_max", {"X": [x]}, {"bit_length": 8}, 1e-6)
    _check("fake_quantize_abs_max",
           {"X": [x], "InScale": [np.array([1.5], "float32")]},
           {"bit_length": 4, "is_test": True}, 1e-6)


def case_fake_quantize_moving_average_abs_max(rs):
    x = _arr(rs, (3, 5))
    scale = np.array([1.2], "float32")
    _check("fake_quantize_moving_average_abs_max",
           {"X": [x], "InScale": [scale]}, {"moving_rate": 0.9}, 1e-6)
    _check("fake_quantize_moving_average_abs_max",
           {"X": [x], "InScale": [scale],
            "InAccum": [np.array([2.0], "float32")],
            "InState": [np.array([1.5], "float32")]},
           {"moving_rate": 0.8}, 1e-6)
    _check("fake_quantize_moving_average_abs_max",
           {"X": [x], "InScale": [scale]}, {"is_test": True}, 1e-6)


def case_fake_quantize_range_abs_max(rs):
    x = _arr(rs, (3, 5))
    for scale, test in ((0.5, False), (9.0, False), (0.7, True)):
        _check("fake_quantize_range_abs_max",
               {"X": [x], "InScale": [np.array([scale], "float32")]},
               {"is_test": test}, 1e-6)


def case_fake_dequantize_max_abs(rs):
    _check("fake_dequantize_max_abs",
           {"X": [np.round(_arr(rs, (3, 4)) * 40)],
            "Scale": [np.array([2.5], "float32")]}, {"max_range": 127.0},
           1e-6)


def case_quantize_channel_abs_max(rs):
    x = _arr(rs, (4, 6))
    for axis, n in ((0, 4), (1, 6)):
        _check("quantize_channel_abs_max",
               {"X": [x], "InScale": [np.abs(_arr(rs, (n,))) + 0.5]},
               {"axis": axis, "bit_length": 8}, 0)


def case_dequantize_channel_abs_max(rs):
    q = rs.randint(-127, 128, (4, 6)).astype("int8")
    for axis, n in ((0, 4), (1, 6)):
        _check("dequantize_channel_abs_max",
               {"X": [q], "Scales": [np.abs(_arr(rs, (n,))) + 0.5]},
               {"axis": axis, "bit_length": 8}, 1e-6)


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def test_every_port_op_has_a_case():
    # grad ops synthesized from a forward lowering (core/autodiff.py)
    # enter the registry when first asked for; they are held against the
    # JAX package in test_torch_training.py. The detection ops' cases
    # live in test_torch_detection.py
    from test_torch_detection import DETECTION_OPS

    assert not set(CASES) & set(DETECTION_OPS)
    assert sorted(list(CASES) + DETECTION_OPS) == [
        t for t in all_ops() if not get_op(t).synthesized]


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_op_matches_jax_lowering(op_type):
    CASES[op_type](np.random.RandomState(0))


def test_float64_is_a_documented_difference():
    """C3: a float64 Program var runs as float64 in the port and as
    float32 in the JAX package (x64 off); the values agree at float32."""
    x = _arr(np.random.RandomState(1), (3, 4)) * 4
    j, t = _run_both("cast", {"X": [x]}, {"out_dtype": "float64"})
    assert j["Out"][0].dtype == np.float32
    assert t["Out"][0].dtype == np.float64
    np.testing.assert_allclose(t["Out"][0], j["Out"][0], atol=1e-6, rtol=0)


def test_range_counts_integer_bounds_exactly():
    """C2: integer attr bounds past 2**24 give every integer, where a
    float32 arange would round them; tensor bounds go through float32 in
    both packages."""
    attrs = {"static_start": 2 ** 24 - 3, "static_end": 2 ** 24 + 8,
             "static_step": 1, "dtype": "int64"}
    _, t = _run_both("range", {}, attrs)
    np.testing.assert_array_equal(t["Out"][0],
                                  np.arange(2 ** 24 - 3, 2 ** 24 + 8))
