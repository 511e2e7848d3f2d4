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
    return to_np(j), {k: [x.numpy() for x in v] for k, v in t.items()}


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


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def test_every_port_op_has_a_case():
    # grad ops synthesized from a forward lowering (core/autodiff.py)
    # enter the registry when first asked for; they are held against the
    # JAX package in test_torch_training.py
    assert sorted(CASES) == [t for t in all_ops()
                             if not get_op(t).synthesized]


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
