"""The port's training slice, held against the JAX package on the CPU.

- Op grads: every differentiable op the port registers, its ``*_grad``
  lowering in both packages on the same numpy inputs and output
  cotangents. Generic grads go through each package's vjp of the forward
  lowering (``torch.func.vjp`` / ``jax.vjp``); custom ones (dropout,
  softmax_with_cross_entropy, fused_attention, and the port's fixed-order
  lookup_table / gather) through their grad lowerings. Tolerances: atol
  1e-5 (f32 sums and transcendentals in another order), 1e-5 plus rtol
  1e-5 for the activations and reductions whose grads grow with their
  inputs, 5e-5 for fused_attention (the JAX package's flash backward
  tolerance; with PADDLE_TPU_FLASH_MIN_SEQ=0 from conftest the JAX side
  runs its Pallas kernels in interpret mode, the port its plain
  versions).
- The whole slice: a 2-layer BERT MLM (the serving test's CFG, dropout
  0.0) built by both packages gives the same main and startup programs
  after ``Adam.minimize``; the JAX startup scope moves into the port with
  ``params_from_jax`` and both take 5 Adam steps (lr 1e-3) on the same
  feeds. Losses agree to a relative 1e-5 and params to atol 1e-4
  (lr / 10): Adam's first step moves a param by lr * g / (|g| + 3e-7),
  so where a grad is zero up to rounding (the key projections': softmax
  ignores a per-row shift of the scores) two packages' rounding noise of
  about 1e-8 moves it by up to about 3e-5 (2.2e-5 measured); every other
  param agrees to about 5e-6.
- Within the port, with dropout 0.1: the same seed gives bitwise the
  same losses in two runs, and the loss falls over 20 steps on one batch.
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
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.analysis import ProgramVerifyError
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.autodiff import ATTR_DIFF, ATTR_FWD_IN, \
    ATTR_FWD_OUT
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import OPS, all_ops, get_op
from paddle_tpu_torch.models import bert as tbert

CPU = torch.device("cpu")
CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
           type_vocab=2, max_length=40, dropout=0.0)
S, M, B = 40, 6, 3
LR = 1e-3


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


def _arr(rs, shape, dtype="float32"):
    if np.dtype(dtype).kind in "iu":
        return rs.randint(0, 10, shape).astype(dtype)
    return rs.randn(*shape).astype(dtype)


def _grads_both(op_type, ins, attrs, diff, rs, cot_slots=None):
    """Run ``<op_type>_grad`` in both packages. The forward outputs come
    from the JAX lowering (the custom grads read them), the output
    cotangents are random for each float output of ``cot_slots`` (all
    by default) and absent for the rest. Returns ({slot@GRAD: [jax]},
    {slot@GRAD: [port]}) as numpy."""
    j_ins = {k: [None if v is None else jnp.asarray(v) for v in vs]
             for k, vs in ins.items()}
    fwd = jax_op(op_type).lowering(JaxContext(None, jax.random.PRNGKey(0)),
                                   j_ins, dict(attrs))
    outs = {k: [None if v is None else np.asarray(v)
                for v in (vs if isinstance(vs, (list, tuple)) else [vs])]
            for k, vs in fwd.items()}
    cots = {}
    for slot, vs in outs.items():
        if cot_slots is not None and slot not in cot_slots:
            continue
        if all(v is not None and np.issubdtype(v.dtype, np.floating)
               for v in vs):
            cots[slot + "@GRAD"] = [
                np.asarray(rs.randn(*v.shape)).astype(v.dtype) for v in vs]
    gattrs = dict(attrs)
    gattrs[ATTR_FWD_IN] = {k: len(v) for k, v in ins.items()}
    gattrs[ATTR_FWD_OUT] = {k: len(v) for k, v in outs.items()}
    gattrs[ATTR_DIFF] = [list(d) for d in diff]
    gins = dict(ins, **outs, **cots)
    jg = jax_op(op_type + "_grad").lowering(
        JaxContext(None, None),
        {k: [None if v is None else jnp.asarray(v) for v in vs]
         for k, vs in gins.items()}, dict(gattrs))
    tg = get_op(op_type + "_grad").lowering(
        LowerContext(None, None, CPU),
        {k: [None if v is None else torch.from_numpy(np.array(v))
             for v in vs] for k, vs in gins.items()}, dict(gattrs))
    return jg, tg


def _check_grad(op_type, ins, attrs, diff, atol, rtol=0.0, cot_slots=None,
                seed=0):
    rs = np.random.RandomState(seed)
    jg, tg = _grads_both(op_type, ins, attrs, diff, rs, cot_slots)
    for slot, i in diff:
        a = np.asarray(jg[slot + "@GRAD"][i])
        b = tg[slot + "@GRAD"][i]
        assert b is not None, (op_type, slot)
        b = b.detach().numpy()
        assert a.shape == b.shape, (op_type, slot, a.shape, b.shape)
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                   err_msg="%s %s@GRAD" % (op_type, slot))
    for slot, vs in tg.items():  # inputs not differentiated take None
        for i, v in enumerate(vs):
            if (slot[:-len("@GRAD")], i) not in diff:
                assert v is None, (op_type, slot, i)


GRAD_CASES = {}


def grad_case(*names):
    def deco(fn):
        for n in names:
            GRAD_CASES[n] = (lambda rs, _n=n, _fn=fn: _fn(rs, _n))
        return fn

    return deco


@grad_case("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow")
def _ew(rs, op):
    x = _arr(rs, (2, 3, 4))
    if op == "elementwise_pow":
        x = np.abs(x) + 0.5
    for y, axis in ((_arr(rs, (3,)), 1), (_arr(rs, (4,)), -1),
                    (_arr(rs, (2, 3, 4)), -1)):
        if op == "elementwise_div":
            y = np.where(np.abs(y) < 0.3, 0.7, y).astype("float32")
        _check_grad(op, {"X": [x], "Y": [y]}, {"axis": axis},
                    [("X", 0), ("Y", 0)], 1e-5, 1e-5)


@grad_case("mul")
def _mul(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 3, 4))], "Y": [_arr(rs, (4, 5))]},
                {"x_num_col_dims": 2, "y_num_col_dims": 1},
                [("X", 0), ("Y", 0)], 1e-5)


@grad_case("sum")
def _sum(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4)) for _ in range(3)]}, {},
                [("X", 0), ("X", 2)], 1e-6)


@grad_case("mean")
def _mean(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4))]}, {}, [("X", 0)], 1e-6)


@grad_case("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod")
def _reduce(rs, op):
    x = _arr(rs, (2, 3, 4))
    if op == "reduce_prod":
        x = np.abs(x) * 0.5 + 0.75
    for attrs in ({"dim": [1]}, {"dim": [0, 2], "keep_dim": True},
                  {"reduce_all": True}):
        _check_grad(op, {"X": [x]}, attrs, [("X", 0)], 1e-5, 1e-5)


@grad_case("assign", "scale")
def _unary_copy(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4))]},
                {"scale": 2.5, "bias": 1.0}, [("X", 0)], 1e-6)


@grad_case("cast")
def _cast(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4))]}, {"out_dtype": "float16"},
                [("X", 0)], 1e-3)


@grad_case("clip", "clip_by_norm", "squared_l2_norm")
def _clip(rs, op):
    x = _arr(rs, (4, 5))
    _check_grad(op, {"X": [x]}, {"min": -0.5, "max": 0.7, "max_norm": 1.0},
                [("X", 0)], 1e-5)


@grad_case("reshape", "reshape2", "transpose", "transpose2", "unsqueeze2")
def _shape(rs, op):
    attrs = {"reshape": {"shape": [0, -1]}, "reshape2": {"shape": [-1, 2]},
             "transpose": {"axis": [2, 0, 1]},
             "transpose2": {"axis": [0, 2, 1]},
             "unsqueeze2": {"axes": [1]}}[op]
    _check_grad(op, {"X": [_arr(rs, (2, 3, 4))]}, attrs, [("X", 0)], 0)


@grad_case("gather")
def _gather(rs, op):
    x = _arr(rs, (6, 4))
    _check_grad(op, {"X": [x], "Index": [np.array([0, 3, 3, 5, 3],
                                                  "int32")]},
                {}, [("X", 0)], 1e-6)
    _check_grad(op, {"X": [_arr(rs, (2, 5, 3))],
                     "Index": [np.array([4, 0, 4], "int32")]},
                {"axis": 1}, [("X", 0)], 1e-6)


@grad_case("lookup_table")
def _lookup_table(rs, op):
    w = _arr(rs, (10, 4))
    ids = np.array([[1, 2, 2], [7, 1, 2]], "int32")  # repeated ids
    _check_grad(op, {"W": [w], "Ids": [ids]}, {"padding_idx": -1},
                [("W", 0)], 1e-6)
    _check_grad(op, {"W": [w], "Ids": [ids[..., None]]},
                {"padding_idx": 2}, [("W", 0)], 1e-6)


@grad_case("layer_norm")
def _layer_norm(rs, op):
    x = _arr(rs, (2, 3, 8)) * 3 + 1
    _check_grad(op, {"X": [x], "Scale": [_arr(rs, (8,))],
                     "Bias": [_arr(rs, (8,))]},
                {"begin_norm_axis": 2, "epsilon": 1e-5},
                [("X", 0), ("Scale", 0), ("Bias", 0)], 1e-5, cot_slots=["Y"])


# the pass pipeline's fused ops: the vjp of each package's composed replay
@grad_case("fused_layernorm_residual")
def _fused_layernorm_residual(rs, op):
    x, r = _arr(rs, (2, 3, 8)), _arr(rs, (2, 3, 8)) * 3 + 1
    _check_grad(op, {"X": [x], "Residual": [r], "Scale": [_arr(rs, (8,))],
                     "Bias": [_arr(rs, (8,))]},
                {"add_attrs": {"axis": -1},
                 "ln_attrs": {"begin_norm_axis": 2, "epsilon": 1e-5}},
                [("X", 0), ("Residual", 0), ("Scale", 0), ("Bias", 0)],
                1e-5, cot_slots=["Y", "ResOut"])


@grad_case("fused_elementwise")
def _fused_elementwise(rs, op):
    ops = [{"type": "elementwise_mul", "attrs": {"axis": -1},
            "ins": {"X": [["x", 0]], "Y": [["x", 1]]}, "out_slot": "Out"},
           {"type": "tanh", "attrs": {}, "ins": {"X": [["t", 0]]},
            "out_slot": "Out"}]
    _check_grad(op, {"X": [_arr(rs, (3, 4)), _arr(rs, (4,))]},
                {"ops": ops}, [("X", 0), ("X", 1)], 1e-5, 1e-5)


@grad_case("dropout")
def _dropout(rs, op):
    # the custom grad multiplies by the saved mask, so no RNG is replayed
    _check_grad(op, {"X": [_arr(rs, (4, 6))]},
                {"dropout_prob": 0.3, "dropout_implementation":
                 "upscale_in_train"}, [("X", 0)], 1e-6, cot_slots=["Out"])


@grad_case("softmax_with_cross_entropy")
def _swce(rs, op):
    logits = _arr(rs, (6, 7)) * 2
    label = np.array([[0], [3], [6], [-100], [2], [3]], "int32")
    diff = [("Logits", 0)]
    _check_grad(op, {"Logits": [logits], "Label": [label]}, {}, diff, 1e-5,
                cot_slots=["Loss"])
    _check_grad(op, {"Logits": [logits], "Label": [np.abs(label) % 7]},
                {"ignore_index": 3}, diff, 1e-5, cot_slots=["Loss"])
    soft = rs.rand(6, 7).astype("float32")
    _check_grad(op, {"Logits": [logits],
                     "Label": [soft / soft.sum(-1, keepdims=True)]},
                {"soft_label": True}, diff, 1e-5, cot_slots=["Loss"])


@grad_case("fused_attention")
def _fused_attention(rs, op):
    q, k, v = (_arr(rs, (2, 2, 40, 16)) for _ in range(3))
    bias = np.zeros((2, 1, 1, 40), "float32")
    bias[1, ..., 30:] = -1e9
    diff = [("Q", 0), ("K", 0), ("V", 0)]
    # dropout 0.1: the saved mask scales the output grad in both packages
    _check_grad(op, {"Q": [q], "K": [k], "V": [v], "Bias": [bias]},
                {"scale": 0.25, "dropout": 0.1, "causal": False}, diff,
                5e-5, cot_slots=["Out"])
    _check_grad(op, {"Q": [q], "K": [k], "V": [v]},
                {"scale": 0.25, "dropout": 0.0, "causal": True}, diff,
                5e-5, cot_slots=["Out"])


# the differentiable ops transformer and GPT add; their grads are the
# generic vjp in both packages
@grad_case("concat")
def _concat(rs, op):
    xs = [_arr(rs, (2, n, 3)) for n in (1, 4, 2)]
    _check_grad(op, {"X": xs}, {"axis": 1}, [("X", 0), ("X", 1), ("X", 2)],
                0)


@grad_case("stack")
def _stack(rs, op):
    xs = [_arr(rs, (2, 3)) for _ in range(3)]
    _check_grad(op, {"X": xs}, {"axis": 1}, [("X", 0), ("X", 1), ("X", 2)],
                0)


@grad_case("slice")
def _slice(rs, op):
    _check_grad(op, {"Input": [_arr(rs, (3, 8, 4))]},
                {"axes": [1, 2], "starts": [2, -3], "ends": [100, 4]},
                [("Input", 0)], 0)


@grad_case("matmul")
def _matmul(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 3, 5, 4))],
                     "Y": [_arr(rs, (2, 3, 6, 4))]},
                {"transpose_Y": True, "alpha": 0.125},
                [("X", 0), ("Y", 0)], 1e-5)
    _check_grad(op, {"X": [_arr(rs, (4, 5))], "Y": [_arr(rs, (4, 3))]},
                {"transpose_X": True}, [("X", 0), ("Y", 0)], 1e-5)


@grad_case("softmax")
def _softmax(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4, 7)) * 2]}, {}, [("X", 0)], 1e-6)


@grad_case("label_smooth")
def _label_smooth(rs, op):
    x = np.eye(6, dtype="float32")[rs.randint(0, 6, (2, 3))]
    _check_grad(op, {"X": [x]}, {"epsilon": 0.1}, [("X", 0)], 1e-7)


@grad_case("rms_norm")
def _rms_norm(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 3, 8)) * 3],
                     "Scale": [_arr(rs, (8,))]},
                {"begin_norm_axis": 2, "epsilon": 1e-6},
                [("X", 0), ("Scale", 0)], 1e-5)


@grad_case("rope")
def _rope(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 3, 6, 8))],
                     "Pos": [np.arange(6).astype("int32")]}, {},
                [("X", 0)], 1e-5)
    _check_grad(op, {"X": [_arr(rs, (2, 3, 6, 8))],
                     "Pos": [(np.arange(12) % 5).reshape(2, 6).astype(
                         "int32")]}, {}, [("X", 0)], 1e-5)


# the image-classification slice: conv2d's grad is its own lowering in
# the port (the vjp of the forward's F.conv2d under the op's cuDNN
# flags), the others are the generic vjp in both packages
@grad_case("conv2d")
def _conv2d(rs, op):
    x = _arr(rs, (2, 4, 9, 8))
    for w_shape, attrs in (
            ((6, 4, 3, 3), {"strides": [2, 2], "paddings": [1, 1]}),
            ((6, 2, 3, 2), {"paddings": [2, 1], "dilations": [2, 1],
                            "groups": 2})):
        _check_grad(op, {"Input": [x], "Filter": [_arr(rs, w_shape)]},
                    attrs, [("Input", 0), ("Filter", 0)], 1e-5, 1e-5)


@grad_case("pool2d")
def _pool2d(rs, op):
    # distinct values: a tie's routing is held in test_torch_vision.py
    x = rs.permutation(2 * 3 * 7 * 6).reshape(2, 3, 7, 6).astype(
        "float32") / 50
    for attrs in ({"pooling_type": "max", "ksize": [3, 3],
                   "strides": [2, 2], "paddings": [1, 1]},
                  {"pooling_type": "avg", "ksize": [3, 3],
                   "strides": [2, 2], "paddings": [1, 1]},
                  {"pooling_type": "avg", "ksize": [2, 3],
                   "strides": [1, 2], "paddings": [1, 1],
                   "exclusive": False},
                  {"pooling_type": "avg", "global_pooling": True}):
        _check_grad(op, {"X": [x]}, attrs, [("X", 0)], 1e-6)


@grad_case("batch_norm")
def _batch_norm(rs, op):
    c = 3
    for x, attrs in ((_arr(rs, (4, c, 5, 6)) * 2 + 1, {}),
                     (_arr(rs, (4, 5, 6, c)), {"data_layout": "NHWC"}),
                     (_arr(rs, (4, c, 5, 6)), {"is_test": True})):
        _check_grad(op, {"X": [x], "Scale": [_arr(rs, (c,))],
                         "Bias": [_arr(rs, (c,))], "Mean": [_arr(rs, (c,))],
                         "Variance": [np.abs(_arr(rs, (c,))) + 0.5]},
                    attrs, [("X", 0), ("Scale", 0), ("Bias", 0)], 1e-5,
                    1e-5, cot_slots=["Y"])


@grad_case("cross_entropy")
def _cross_entropy(rs, op):
    p = rs.rand(6, 7).astype("float32") + 0.05
    p /= p.sum(-1, keepdims=True)
    label = np.array([[0], [3], [6], [-100], [2], [3]], "int32")
    _check_grad(op, {"X": [p], "Label": [label]}, {}, [("X", 0)], 1e-5,
                1e-5)
    _check_grad(op, {"X": [p], "Label": [label]}, {"ignore_index": 3},
                [("X", 0)], 1e-5, 1e-5)
    soft = rs.rand(6, 7).astype("float32")
    _check_grad(op, {"X": [p], "Label": [soft / soft.sum(-1,
                                                         keepdims=True)]},
                {"soft_label": True}, [("X", 0)], 1e-5, 1e-5)

ACTIVATIONS = ["relu", "sigmoid", "tanh", "sqrt", "rsqrt", "abs", "exp",
               "log", "square", "reciprocal", "softplus", "softsign",
               "ceil", "floor", "round", "cos", "sin", "gelu", "relu6",
               "leaky_relu", "elu", "pow", "stanh", "hard_sigmoid",
               "hard_swish", "swish", "brelu", "soft_relu", "logsigmoid",
               "tanh_shrink", "thresholded_relu", "hard_shrink", "mish",
               "silu"]
_POSITIVE = {"sqrt", "rsqrt", "log", "reciprocal", "pow"}


@grad_case(*ACTIVATIONS)
def _act(rs, op):
    # inputs keep clear of the kinks (0, thresholds) where the two
    # packages may pick different one-sided derivatives
    x = rs.uniform(0.15, 2.5, (4, 6)).astype("float32")
    x *= np.where(rs.rand(4, 6) < 0.5, -1.0, 1.0).astype("float32")
    if op in _POSITIVE:
        x = np.abs(x)
    attrs_list = {"gelu": [{}, {"approximate": True}],
                  "pow": [{"factor": 1.5}]}.get(op, [{}])
    for attrs in attrs_list:
        _check_grad(op, {"X": [x]}, attrs, [("X", 0)], 1e-5, 1e-5)


@grad_case("where_op")
def _where(rs, op):
    cond = rs.rand(4, 6) < 0.5
    _check_grad(op, {"Condition": [cond], "X": [_arr(rs, (4, 6))],
                     "Y": [_arr(rs, (4, 6))]}, {}, [("X", 0), ("Y", 0)],
                1e-6)


@grad_case("recompute_block")
def _recompute_block(rs, op):
    """One segment [fc, tanh] (core/recompute.py in each package): the
    grad lowering re-runs it under each package's vjp, on the same
    inputs and output cotangent."""
    from importlib import import_module

    def segment(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [6])
            h = pkg.layers.fc(x, 5, act="tanh")
            pkg.layers.mean(pkg.layers.scale(h, 2.0))
        import_module(pkg.__name__ + ".core.recompute").apply_recompute(
            main, [h])
        block = main.global_block()
        return block, next(o for o in block.ops
                           if o.type == "recompute_block")

    (jblock, jop), (tblock, top) = segment(jf), segment(pt)
    shapes = {"x": (3, 6), "fc_0.w_0": (6, 5), "fc_0.b_0": (5,)}
    xs = [_arr(rs, shapes[n]) for n in jop.attrs["input_vars"]]
    out = np.tanh(xs[0] @ xs[1] + xs[2]).astype("float32")
    ins = {"X": xs, "Out": [out], "Out@GRAD": [_arr(rs, (3, 5))]}
    attrs = dict(jop.attrs, **{ATTR_FWD_IN: {"X": 3},
                               ATTR_FWD_OUT: {"Out": 1},
                               ATTR_DIFF: [["X", i] for i in range(3)]})
    jg = jax_op(op + "_grad").lowering(
        JaxContext(jblock, None),
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    tg = get_op(op + "_grad").lowering(
        LowerContext(tblock, None, CPU),
        {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    for i in range(3):
        np.testing.assert_allclose(tg["X@GRAD"][i].numpy(),
                                   np.asarray(jg["X@GRAD"][i]), atol=1e-5,
                                   rtol=0, err_msg="X@GRAD %d" % i)



# the sequence, recurrent and control-flow slice: the generic vjp in
# both packages (recurrent and scan_layers: their custom grads, held on
# whole programs); lengths hold 1 and T (= 5). The recurrent ops' grads
# sum f32 products over every step, in another order in each package:
# atol 1e-5 plus rtol 1e-6
_SEQ_LENS = np.array([1, 5, 3, 5], "int32")


@grad_case("sequence_pool")
def _sequence_pool(rs, op):
    for ptype in ("average", "sum", "sqrt", "max", "last", "first"):
        _check_grad(op, {"X": [_arr(rs, (4, 5, 3))], "Length": [_SEQ_LENS]},
                    {"pool_type": ptype}, [("X", 0)], 1e-6)


@grad_case("sequence_softmax", "sequence_reverse", "sequence_unpad",
           "sequence_pad")
def _sequence_masked(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 5))], "Length": [_SEQ_LENS]}, {},
                [("X", 0)], 1e-6, cot_slots=["Out", "Y"])


@grad_case("sequence_expand")
def _sequence_expand(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4))], "Y": [_arr(rs, (3, 2, 4))]},
                {}, [("X", 0)], 1e-6)


@grad_case("sequence_expand_as")
def _sequence_expand_as(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 4))], "Y": [_arr(rs, (6, 4))]}, {},
                [("X", 0)], 1e-6)


@grad_case("sequence_conv")
def _sequence_conv(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 5, 3))],
                     "Filter": [_arr(rs, (9, 6))], "Length": [_SEQ_LENS]},
                {"context_length": 3, "context_start": -1},
                [("X", 0), ("Filter", 0)], 1e-5)


@grad_case("sequence_concat")
def _sequence_concat(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 5, 2)), _arr(rs, (4, 3, 2))],
                     "Length": [_SEQ_LENS, np.array([3, 1, 2, 3], "int32")]},
                {}, [("X", 0), ("X", 1)], 1e-6, cot_slots=["Out"])


@grad_case("sequence_slice")
def _sequence_slice(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 5, 2))],
                     "Offset": [np.array([[0], [1], [4], [2]], "int32")],
                     "SliceLength": [np.array([[1], [4], [1], [3]],
                                              "int32")]},
                {}, [("X", 0)], 1e-6, cot_slots=["Out"])


@grad_case("row_conv")
def _row_conv(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 5, 3))], "Filter": [_arr(rs, (3, 3))]},
                {}, [("X", 0), ("Filter", 0)], 1e-5)


@grad_case("lstm")
def _lstm(rs, op):
    D = 4
    ins = {"Input": [_arr(rs, (4, 5, 4 * D))], "Weight": [_arr(rs, (D, 4 * D))],
           "Bias": [_arr(rs, (1, 4 * D))], "H0": [_arr(rs, (4, D))],
           "C0": [_arr(rs, (4, D))], "Length": [_SEQ_LENS]}
    diff = [("Input", 0), ("Weight", 0), ("Bias", 0), ("H0", 0), ("C0", 0)]
    for attrs in ({}, {"is_reverse": True}):
        _check_grad(op, ins, attrs, diff, 1e-5, rtol=1e-6)


@grad_case("gru")
def _gru(rs, op):
    D = 4
    ins = {"Input": [_arr(rs, (4, 5, 3 * D))], "Weight": [_arr(rs, (D, 3 * D))],
           "Bias": [_arr(rs, (1, 3 * D))], "H0": [_arr(rs, (4, D))],
           "Length": [_SEQ_LENS]}
    diff = [("Input", 0), ("Weight", 0), ("Bias", 0), ("H0", 0)]
    for attrs in ({}, {"is_reverse": True, "origin_mode": True}):
        _check_grad(op, ins, attrs, diff, 1e-5, rtol=1e-6)


@grad_case("lstmp")
def _lstmp(rs, op):
    D, P = 4, 3
    _check_grad(op, {"Input": [_arr(rs, (4, 5, 4 * D))],
                     "Weight": [_arr(rs, (P, 4 * D))],
                     "ProjWeight": [_arr(rs, (D, P))],
                     "Bias": [_arr(rs, (1, 4 * D))], "Length": [_SEQ_LENS]},
                {}, [("Input", 0), ("Weight", 0), ("ProjWeight", 0),
                     ("Bias", 0)], 1e-5, rtol=1e-6)


@grad_case("gru_unit")
def _gru_unit(rs, op):
    D = 4
    _check_grad(op, {"Input": [_arr(rs, (3, 3 * D))],
                     "HiddenPrev": [_arr(rs, (3, D))],
                     "Weight": [_arr(rs, (D, 3 * D))],
                     "Bias": [_arr(rs, (1, 3 * D))]}, {"origin_mode": True},
                [("Input", 0), ("HiddenPrev", 0), ("Weight", 0),
                 ("Bias", 0)], 1e-5)


@grad_case("lstm_unit")
def _lstm_unit(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 16))], "C_prev": [_arr(rs, (3, 4))]},
                {"forget_bias": 0.5}, [("X", 0), ("C_prev", 0)], 1e-6)


@grad_case("print_op", "squeeze2")
def _print_squeeze(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 1, 3))]},
                {"message": "g", "name": "x", "axes": [1]}, [("X", 0)], 0,
                cot_slots=["Out"])


@grad_case("expand")
def _expand(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 1, 3))]},
                {"expand_times": [2, 3, 1]}, [("X", 0)], 1e-6)


# the op tail and the loss ops: shape and copy ops exact or 1e-6, the
# products, convs, norms and losses 1e-5, the scans (warpctc,
# linear_chain_crf) 1e-5 plus rtol 1e-6, as the recurrent ops
@grad_case("split", "squeeze", "unsqueeze", "flatten", "flatten2",
           "unstack", "strided_slice", "expand_as", "tile", "pad", "pad2d",
           "crop", "reverse", "roll", "share_data")
def _tail_shape(rs, op):
    x = _arr(rs, (2, 3, 4))
    ins = {"X": [x]}
    attrs = {
        "split": {"axis": 2, "sections": [1, 3]},
        "squeeze": {}, "unsqueeze": {"axes": [0, 3]},
        "flatten": {"axis": 2}, "flatten2": {"axis": 1},
        "unstack": {"axis": 1},
        "strided_slice": {"axes": [0, 2], "starts": [1, 3], "ends": [2, 0],
                          "strides": [1, -2]},
        "expand_as": {}, "tile": {"repeat_times": [2, 1, 2]},
        "pad": {"paddings": [1, 0, 0, 2, 1, 1], "pad_value": 0.5},
        "pad2d": {"paddings": [1, 0, 2, 1], "mode": "reflect"},
        "crop": {"offsets": [0, 1, 1], "shape": [2, 2, 2]},
        "reverse": {"axis": [0, 2]},
        "roll": {"shifts": [1, -1], "axis": [1, 2]}, "share_data": {}}[op]
    if op == "squeeze":
        ins = {"X": [_arr(rs, (2, 1, 4))]}
    if op == "expand_as":
        ins = {"X": [_arr(rs, (2, 1, 4))],
               "target_tensor": [_arr(rs, (2, 3, 4))]}
    if op == "pad2d":
        ins = {"X": [_arr(rs, (2, 3, 4, 5))]}
        for mode in ("constant", "edge"):
            _check_grad(op, ins, dict(attrs, mode=mode), [("X", 0)], 1e-6)
    if op == "strided_slice":
        ins = {"Input": [x]}
    _check_grad(op, ins, attrs, [(next(iter(ins)), 0)], 1e-6)


@grad_case("gather_nd")
def _g_gather_nd(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 5, 3))],
                     "Index": [np.array([[0, 1], [3, 4], [0, 1]], "int32")]},
                {}, [("X", 0)], 1e-6)


@grad_case("scatter")
def _g_scatter(rs, op):
    ins = {"X": [_arr(rs, (6, 3))], "Ids": [np.array([4, 0, 2], "int32")],
           "Updates": [_arr(rs, (3, 3))]}
    for overwrite in (True, False):
        _check_grad(op, ins, {"overwrite": overwrite},
                    [("X", 0), ("Updates", 0)], 1e-6)


@grad_case("meshgrid")
def _g_meshgrid(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3,)), _arr(rs, (4,))]}, {},
                [("X", 0), ("X", 1)], 1e-5)


@grad_case("matmul_v2", "bmm")
def _g_matmul_v2(rs, op):
    attrs = {"trans_x": True} if op == "matmul_v2" else {}
    x = _arr(rs, (2, 4, 3)) if op == "matmul_v2" else _arr(rs, (2, 3, 4))
    _check_grad(op, {"X": [x], "Y": [_arr(rs, (2, 4, 5))]}, attrs,
                [("X", 0), ("Y", 0)], 1e-5)


@grad_case("cumsum", "norm", "dot", "log_softmax")
def _g_reducing(rs, op):
    attrs = {"cumsum": {"axis": 1, "exclusive": True, "reverse": True},
             "norm": {"axis": 1}, "dot": {}, "log_softmax": {"axis": 1}}[op]
    ins = {"X": [_arr(rs, (3, 4, 2))]}
    if op == "dot":
        ins = {"X": [_arr(rs, (3, 4))], "Y": [_arr(rs, (3, 4))]}
    _check_grad(op, ins, attrs, [(k, 0) for k in ins], 1e-5, 1e-5)


@grad_case("prelu")
def _g_prelu(rs, op):
    x = _arr(rs, (2, 3, 4, 5))
    for mode, alpha in (("all", _arr(rs, (1,))), ("channel", _arr(rs, (3,))),
                        ("element", _arr(rs, (1, 3, 4, 5)))):
        _check_grad(op, {"X": [x], "Alpha": [alpha]}, {"mode": mode},
                    [("X", 0), ("Alpha", 0)], 1e-5)


@grad_case("depthwise_conv2d", "conv2d_transpose", "conv3d")
def _g_convs(rs, op):
    if op == "conv3d":
        x, w = _arr(rs, (2, 4, 4, 5, 4)), _arr(rs, (4, 2, 2, 3, 2))
        attrs = {"strides": [1, 2, 1], "paddings": [1, 0, 1], "groups": 2}
    elif op == "conv2d_transpose":
        x, w = _arr(rs, (2, 4, 5, 6)), _arr(rs, (4, 3, 3, 2))
        attrs = {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2]}
    else:
        x, w = _arr(rs, (2, 4, 7, 6)), _arr(rs, (8, 1, 3, 3))
        attrs = {"strides": [2, 1], "paddings": [1, 1], "groups": 4}
    _check_grad(op, {"Input": [x], "Filter": [w]}, attrs,
                [("Input", 0), ("Filter", 0)], 1e-5)


@grad_case("pool2d_with_index", "maxout")
def _g_max(rs, op):
    x = _arr(rs, (2, 6, 5, 4))
    attrs = {"ksize": [3, 2], "strides": [2, 2], "paddings": [1, 0],
             "groups": 3}
    _check_grad(op, {"X": [x]}, attrs, [("X", 0)], 1e-6, cot_slots=["Out"])


@grad_case("group_norm", "lrn")
def _g_norms(rs, op):
    x = _arr(rs, (2, 6, 3, 4)) * 2 + 1
    if op == "lrn":
        _check_grad(op, {"X": [x]}, {"n": 3, "alpha": 0.1}, [("X", 0)],
                    1e-5, cot_slots=["Out"])
        return
    _check_grad(op, {"X": [x], "Scale": [_arr(rs, (6,))],
                     "Bias": [_arr(rs, (6,))]}, {"groups": 3},
                [("X", 0), ("Scale", 0), ("Bias", 0)], 1e-5, cot_slots=["Y"])


@grad_case("sigmoid_cross_entropy_with_logits", "square_error_cost",
           "smooth_l1_loss", "huber_loss", "log_loss", "rank_loss",
           "margin_rank_loss", "cos_sim", "bpr_loss")
def _g_losses(rs, op):
    x, y = _arr(rs, (5, 3)) * 2, _arr(rs, (5, 3))
    if op == "sigmoid_cross_entropy_with_logits":
        label = rs.rand(5, 3).astype("float32")
        label[1, 2] = -100.0
        _check_grad(op, {"X": [x], "Label": [label]}, {"normalize": True},
                    [("X", 0)], 1e-5)
    elif op in ("square_error_cost", "huber_loss"):
        _check_grad(op, {"X": [x], "Y": [y]}, {"delta": 0.7},
                    [("X", 0), ("Y", 0)], 1e-5)
    elif op == "smooth_l1_loss":
        _check_grad(op, {"X": [x], "Y": [y]}, {"sigma": 2.0}, [("X", 0)],
                    1e-5)
    elif op == "log_loss":
        _check_grad(op, {"Predicted": [rs.rand(5, 1).astype("float32")],
                         "Labels": [rs.randint(0, 2, (5, 1)).astype(
                             "float32")]}, {}, [("Predicted", 0)], 1e-5)
    elif op == "rank_loss":
        _check_grad(op, {"Label": [rs.randint(0, 2, (5, 1)).astype(
            "float32")], "Left": [x[:, :1]], "Right": [y[:, :1]]}, {},
            [("Left", 0), ("Right", 0)], 1e-5)
    elif op == "margin_rank_loss":
        _check_grad(op, {"Label": [np.sign(_arr(rs, (5, 1)))],
                         "X1": [x[:, :1]], "X2": [y[:, :1]]},
                    {"margin": 0.1}, [("X1", 0), ("X2", 0)], 1e-5,
                    cot_slots=["Out"])
    elif op == "cos_sim":
        _check_grad(op, {"X": [x], "Y": [y[:1]]}, {}, [("X", 0), ("Y", 0)],
                    1e-5)
    else:
        _check_grad(op, {"X": [x], "Label": [np.array(
            [[0], [2], [1], [1], [0]], "int32")]}, {}, [("X", 0)], 1e-5)


@grad_case("lookup_table_v2")
def _g_lookup_table_v2(rs, op):
    ids = np.array([[1, 2, 2], [7, 1, 2]], "int32")
    _check_grad(op, {"W": [_arr(rs, (10, 4))], "Ids": [ids]},
                {"padding_idx": 2}, [("W", 0)], 1e-6)


@grad_case("nce")
def _g_nce(rs, op):
    """Both grad lowerings replay the JAX forward's SampleLabels."""
    ins = {"Input": [_arr(rs, (4, 6))], "Weight": [_arr(rs, (12, 6))],
           "Bias": [_arr(rs, (12,))],
           "Label": [np.array([[3], [0], [11], [3]], "int32")]}
    _check_grad(op, ins, {"num_neg_samples": 5, "num_total_classes": 12},
                [("Input", 0), ("Weight", 0), ("Bias", 0)], 1e-5,
                cot_slots=["Cost"])


@grad_case("hierarchical_sigmoid")
def _g_hsigmoid(rs, op):
    _check_grad(op, {"X": [_arr(rs, (6, 5))], "W": [_arr(rs, (6, 5))],
                     "Bias": [_arr(rs, (6,))],
                     "Label": [np.array([[0], [1], [6], [3], [2], [5]],
                                        "int32")]},
                {"num_classes": 7}, [("X", 0), ("W", 0), ("Bias", 0)], 1e-5,
                cot_slots=["Out"])


@grad_case("warpctc", "linear_chain_crf")
def _g_scans(rs, op):
    lengths = np.array([0, 1, 6, 3], "int32")
    if op == "warpctc":
        label = rs.randint(1, 5, (4, 3)).astype("int32")
        _check_grad(op, {"Logits": [_arr(rs, (4, 6, 5)) * 2],
                         "Label": [label],
                         "LogitsLength": [np.array([1, 2, 6, 4], "int32")],
                         "LabelLength": [np.array([0, 1, 3, 2], "int32")]},
                    {"blank": 0}, [("Logits", 0)], 1e-5, 1e-6)
        return
    _check_grad(op, {"Emission": [_arr(rs, (4, 6, 4))],
                     "Transition": [_arr(rs, (6, 4)) * 0.5],
                     "Label": [rs.randint(0, 4, (4, 6)).astype("int32")],
                     "Length": [lengths]}, {},
                [("Emission", 0), ("Transition", 0)], 1e-5, 1e-6,
                cot_slots=["LogLikelihood"])


@grad_case("bilinear_interp", "nearest_interp", "affine_channel")
def _g_interp(rs, op):
    x = _arr(rs, (2, 3, 4, 5))
    if op == "affine_channel":
        _check_grad(op, {"X": [x], "Scale": [_arr(rs, (3,))],
                         "Bias": [_arr(rs, (3,))]}, {},
                    [("X", 0), ("Scale", 0), ("Bias", 0)], 1e-5)
        return
    for attrs in ({"out_h": 7, "out_w": 3},
                  {"out_h": 6, "out_w": 9, "align_corners": False}):
        _check_grad(op, {"X": [x]}, attrs, [("X", 0)], 1e-5)


def _program_grads(build, feed):
    """Both packages' grads of every parameter of ``build``'s program
    (``append_backward`` of its loss), on the JAX startup's weights."""
    from importlib import import_module

    from torch_parity import run_both

    def with_grads(pkg):
        loss = build(pkg)
        params = pkg.default_main_program().global_block().all_parameters()
        import_module(pkg.__name__ + ".core.backward").append_backward(loss)
        return [loss] + [pkg.default_main_program().global_block().var(
            p.name + "@GRAD") for p in params]

    jres, tres, _, _ = run_both(with_grads, [feed])
    assert len(jres[0]) > 1
    for a, b in zip(jres[0], tres[0]):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-6)


@grad_case("recurrent")
def _recurrent(rs, op):
    """StaticRNN and DynamicRNN (with lengths 1 and T) over an fc step:
    the grad re-runs the loop in each package."""
    xs = _arr(rs, (4, 3, 2))
    ds = _arr(rs, (3, 5, 2))
    w = _arr(rs, (3, 5, 6))

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4, 3, 2], append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)
            prev = rnn.memory(shape=[-1, 6], batch_ref=word,
                              ref_batch_dim_idx=1)
            h = L.fc([word, prev], size=6, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        d = L.data("d", [3, 5, 2], append_batch_size=False)
        ln = L.data("ln", [3], dtype="int64", append_batch_size=False)
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(d, length=ln)
            prev = drnn.memory(shape=[6], value=0.0, dtype="float32")
            h = L.fc([word, prev], size=6, act="tanh")
            drnn.update_memory(prev, h)
            drnn.output(h)
        wv = L.assign(w)
        return L.elementwise_add(
            L.mean(rnn()), L.mean(L.elementwise_mul(drnn(), wv)))

    _program_grads(build, {"x": xs, "d": ds,
                           "ln": np.array([1, 5, 3], "int64")})


@grad_case("moe_ffn")
def _moe_ffn(rs, op):
    """Top-2 with overflow and the z-loss: every param's grad (the
    experts', the router's through the gates and the aux loss)."""
    def build(pkg):
        L = pkg.layers
        out, aux = L.moe_ffn(L.data("x", [8]), n_experts=4, d_hidden=16,
                             capacity=3, top_k=2, z_loss=1e-2)
        return L.elementwise_add(L.mean(L.square(out)), aux)

    _program_grads(build, {"x": _arr(rs, (12, 8))})


@grad_case("pipeline")
def _pipeline(rs, op):
    """Three stages through the op's own grad (the forward re-run under
    autograd)."""
    def build(pkg):
        L = pkg.layers

        def stage(pb, h):
            return L.tanh(L.elementwise_add(L.matmul(h, pb.param([8, 8])),
                                            pb.param([8], is_bias=True)))

        y = L.pipeline(L.fc(L.data("x", [8]), 8), n_stages=3,
                       stage_fn=stage, n_microbatches=2)
        return L.mean(L.square(y))

    _program_grads(build, {"x": _arr(rs, (4, 8))})


@grad_case("scan_layers")
def _scan_layers(rs, op):
    """Three fc layers with a captured tensor, plain and remat."""
    x = _arr(rs, (3, 4))
    for remat in (False, True):
        def build(pkg, _remat=remat):
            L = pkg.layers
            xv = L.data("x", [4])
            cap = L.scale(xv, 0.5)
            y = L.scan_layers(
                xv, 3, lambda h: L.elementwise_add(
                    L.fc(h, size=4, act="tanh"), cap), remat=_remat)
            return L.mean(L.square(y))

        _program_grads(build, {"x": x})


def _py_forward(x, y):
    return 2 * x + y, x * y


def _py_backward(da, db):
    return 2 * da + db, da + db


@grad_case("py_layer")
def _g_py_layer(rs, op):
    # the dygraph PyLayer: the user's numpy backward in both packages
    xs = [_arr(rs, (3, 4)) for _ in range(2)]
    _check_grad(op, {"X": xs}, {"__forward__": _py_forward,
                                "__backward__": _py_backward},
                [("X", 0), ("X", 1)], 0)

# ------------------------------------------- misc_ops' tail and quant_ops
@grad_case("selu")
def _g_selu(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 5))]}, {}, [("X", 0)], 1e-5, 1e-6)


@grad_case("multiplex")
def _g_multiplex(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 3)) for _ in range(3)],
                     "Ids": [np.array([[2], [0], [2], [1]], "int32")]}, {},
                [("X", 0), ("X", 2)], 0)


@grad_case("space_to_depth", "shuffle_channel")
def _g_layout(rs, op):
    attrs = {"blocksize": 2, "group": 2}
    _check_grad(op, {"X": [_arr(rs, (2, 4, 4, 2))]}, attrs, [("X", 0)], 0)


@grad_case("pad_constant_like")
def _g_pad_constant_like(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 5))], "Y": [_arr(rs, (2, 3))]},
                {"pad_value": 0.5}, [("Y", 0)], 0)


@grad_case("dice_loss_op")
def _g_dice(rs, op):
    _check_grad(op, {"X": [np.abs(_arr(rs, (4, 5, 3)))],
                     "Label": [rs.randint(0, 3, (4, 5, 1)).astype("int32")]},
                {}, [("X", 0)], 1e-6)


@grad_case("add_position_encoding")
def _g_ape(rs, op):
    _check_grad(op, {"X": [_arr(rs, (2, 5, 6))]}, {"alpha": 0.5, "beta": 2},
                [("X", 0)], 1e-6)


@grad_case("bilinear_tensor_product")
def _g_btp(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4))], "Y": [_arr(rs, (3, 5))],
                     "Weight": [_arr(rs, (6, 4, 5))],
                     "Bias": [_arr(rs, (1, 6))]}, {},
                [("X", 0), ("Y", 0), ("Weight", 0), ("Bias", 0)], 1e-5)


@grad_case("teacher_student_sigmoid_loss")
def _g_tssl(rs, op):
    label = np.array([[-2.0], [-1.0], [0.3], [1.6]], "float32")
    _check_grad(op, {"X": [_arr(rs, (4, 1))], "Label": [label]}, {},
                [("X", 0)], 1e-6)


@grad_case("npair_loss_op")
def _g_npair(rs, op):
    _check_grad(op, {"Anchor": [_arr(rs, (5, 4))],
                     "Positive": [_arr(rs, (5, 4))],
                     "Labels": [np.array([1, 2, 1, 3, 2], "int32")]}, {},
                [("Anchor", 0), ("Positive", 0)], 1e-5)


@grad_case("pool3d")
def _g_pool3d(rs, op):
    x = _arr(rs, (2, 2, 4, 5, 4))
    for attrs in ({"pooling_type": "max", "ksize": [2, 2, 2],
                   "strides": [1, 2, 1], "paddings": [1, 0, 1]},
                  {"pooling_type": "avg", "ksize": [3, 3, 3],
                   "strides": [1, 1, 1], "paddings": [1, 1, 1]}):
        _check_grad(op, {"X": [x]}, attrs, [("X", 0)], 1e-6)


@grad_case("adaptive_pool3d")
def _g_adaptive_pool3d(rs, op):
    for ptype in ("max", "avg"):
        _check_grad(op, {"X": [_arr(rs, (2, 2, 4, 4, 6))]},
                    {"ksize": [2, 2, 3], "pooling_type": ptype},
                    [("X", 0)], 1e-6)


@grad_case("conv3d_transpose")
def _g_conv3d_transpose(rs, op):
    _check_grad(op, {"Input": [_arr(rs, (2, 3, 3, 4, 3))],
                     "Filter": [_arr(rs, (3, 2, 2, 3, 2))]},
                {"strides": [2, 1, 1], "paddings": [0, 1, 0]},
                [("Input", 0), ("Filter", 0)], 1e-4)


@grad_case("spectral_norm")
def _g_spectral_norm(rs, op):
    _check_grad(op, {"Weight": [_arr(rs, (4, 3, 2))],
                     "U": [_arr(rs, (4,))]},
                {"dim": 0, "power_iters": 2}, [("Weight", 0)], 1e-5)


@grad_case("affine_grid")
def _g_affine_grid(rs, op):
    _check_grad(op, {"Theta": [_arr(rs, (2, 2, 3))]},
                {"output_shape": [2, 3, 4, 5]}, [("Theta", 0)], 1e-5)


@grad_case("grid_sampler")
def _g_grid_sampler(rs, op):
    grid = (rs.rand(2, 3, 4, 2) * 2.2 - 1.1).astype("float32")
    _check_grad(op, {"X": [_arr(rs, (2, 3, 5, 4))], "Grid": [grid]}, {},
                [("X", 0), ("Grid", 0)], 1e-5)


@grad_case("sequence_scatter")
def _g_sequence_scatter(rs, op):
    ids = np.array([[0, 2, 2, 5], [1, 1, 3, 1]], "int32")
    _check_grad(op, {"X": [_arr(rs, (2, 6))], "Ids": [ids],
                     "Updates": [_arr(rs, (2, 4))],
                     "Length": [np.array([3, 4], "int32")]}, {},
                [("X", 0), ("Updates", 0)], 1e-6)


@grad_case("data_norm")
def _g_data_norm(rs, op):
    _check_grad(op, {"X": [_arr(rs, (4, 3))],
                     "BatchSize": [np.full((3,), 10.0, "float32")],
                     "BatchSum": [_arr(rs, (3,))],
                     "BatchSquareSum": [np.abs(_arr(rs, (3,))) * 20 + 10]},
                {}, [("X", 0)], 1e-5)


@grad_case("sampled_softmax_with_cross_entropy")
def _g_sampled_softmax(rs, op):
    """No gradient in either package: the generic grad re-runs the
    forward, whose negatives are drawn, in a context without RNG; both
    refuse with the same error (ROADMAP C)."""
    ins = {"Logits": [_arr(rs, (3, 20))],
           "Label": [np.array([[1], [4], [19]], "int32")]}
    with pytest.raises(RuntimeError, match="RNG in a pure context"):
        _check_grad(op, ins, {"num_samples": 5}, [("Logits", 0)], 1e-6)
    gattrs = {"num_samples": 5, ATTR_FWD_IN: {"Logits": 1, "Label": 1},
              ATTR_FWD_OUT: {"Loss": 1}, ATTR_DIFF: [["Logits", 0]]}
    gins = dict(ins, Loss=[np.zeros((3, 1), "float32")],
                **{"Loss@GRAD": [np.ones((3, 1), "float32")]})
    with pytest.raises(RuntimeError, match="RNG in a pure context"):
        get_op(op + "_grad").lowering(
            LowerContext(None, torch.Generator(), CPU),
            {k: [torch.from_numpy(v) for v in vs] for k, vs in gins.items()},
            gattrs)


@grad_case("psroi_pool")
def _g_psroi_pool(rs, op):
    rois = np.array([[0.5, 1.0, 4.0, 4.5], [2.0, 0.0, 5.5, 3.5]], "float32")
    _check_grad(op, {"X": [_arr(rs, (2, 2 * 2 * 2, 5, 6))], "ROIs": [rois],
                     "RoisBatch": [np.array([1, 0], "int32")]},
                {"pooled_height": 2, "pooled_width": 2,
                 "output_channels": 2, "spatial_scale": 1.0},
                [("X", 0)], 1e-6)


@grad_case("tree_conv")
def _g_tree_conv(rs, op):
    edges = np.array([[[1, 2], [1, 3], [2, 4], [0, 0]],
                      [[0, 1], [0, 2], [0, 3], [3, 4]]], "int32")
    _check_grad(op, {"NodesVector": [_arr(rs, (2, 5, 3))],
                     "EdgeSet": [edges], "Filter": [_arr(rs, (3, 3, 2, 4))]},
                {}, [("NodesVector", 0), ("Filter", 0)], 1e-5)


@grad_case("fake_quantize_abs_max", "fake_quantize_range_abs_max",
           "fake_quantize_moving_average_abs_max")
def _g_fake_quant(rs, op):
    """The straight-through grads (custom lowerings in both packages)."""
    ins = {"X": [_arr(rs, (3, 4))]}
    if op != "fake_quantize_abs_max":
        ins["InScale"] = [np.array([1.5], "float32")]
    _check_grad(op, ins, {"bit_length": 8}, [("X", 0)], 0,
                cot_slots=["Out"])


@grad_case("fake_dequantize_max_abs")
def _g_fake_dequant(rs, op):
    _check_grad(op, {"X": [_arr(rs, (3, 4))],
                     "Scale": [np.array([2.5], "float32")]},
                {"max_range": 127.0}, [("X", 0)], 1e-6)


@grad_case("roi_align", "roi_pool")
def _g_roi(rs, op):
    rois = np.array([[0.5, 1.0, 5.0, 4.5], [2.0, 0.0, 6.5, 6.5],
                     [-2.0, 3.0, 9.5, 8.0]], "float32")
    _check_grad(op, {"X": [_arr(rs, (2, 3, 7, 8))], "ROIs": [rois],
                     "RoisBatch": [np.array([1, 0, 1], "int32")]},
                {"pooled_height": 2, "pooled_width": 3,
                 "spatial_scale": 0.9, "sampling_ratio": 2},
                [("X", 0)], 1e-5, cot_slots=["Out"])


@grad_case("ssd_loss")
def _g_ssd_loss(rs, op):
    P, G = 30, 4
    lo = rs.rand(P, 2) * 0.7
    prior = np.concatenate([lo, lo + rs.rand(P, 2) * 0.3 + 0.05],
                           1).astype("float32")
    gt = np.zeros((2, G, 4), "float32")
    gt[:, :3] = prior[rs.randint(0, P, (2, 3))] + 0.01
    _check_grad(op, {"Location": [_arr(rs, (2, P, 4))],
                     "Confidence": [_arr(rs, (2, P, 5))], "GTBox": [gt],
                     "GTLabel": [rs.randint(1, 5, (2, G)).astype("int32")],
                     "PriorBox": [prior]}, {"neg_pos_ratio": 2.0},
                [("Location", 0), ("Confidence", 0)], 1e-5)


@grad_case("yolov3_loss")
def _g_yolov3_loss(rs, op):
    gt = np.zeros((2, 4, 4), "float32")
    gt[:, :3, :2] = rs.rand(2, 3, 2) * 0.9 + 0.05
    gt[:, :3, 2:] = rs.rand(2, 3, 2) * 0.4 + 0.05
    _check_grad(op, {"X": [_arr(rs, (2, 16, 5, 5))], "GTBox": [gt],
                     "GTLabel": [rs.randint(0, 3, (2, 4)).astype("int32")]},
                {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 1],
                 "class_num": 3, "ignore_thresh": 0.5,
                 "downsample_ratio": 32}, [("X", 0)], 1e-5,
                cot_slots=["Loss"])


def test_every_differentiable_port_op_has_a_grad_case():
    want = sorted(t for t in all_ops()
                  if not get_op(t).no_grad and not get_op(t).synthesized)
    assert sorted(GRAD_CASES) == want


@pytest.mark.parametrize("op_type", sorted(GRAD_CASES))
def test_grad_matches_jax(op_type):
    GRAD_CASES[op_type](np.random.RandomState(1))


def test_generic_grad_contract():
    """Zero cotangents for absent output grads, a broadcast cotangent of
    another dtype, and None for inputs not differentiated."""
    rs = np.random.RandomState(2)
    x, y = _arr(rs, (2, 3, 4)), _arr(rs, (4,))
    out = x + y
    base = {"X": [x], "Y": [y], "Out": [out]}
    attrs = {ATTR_FWD_IN: {"X": 1, "Y": 1}, ATTR_FWD_OUT: {"Out": 1},
             "axis": -1}
    g = rs.randn(1, 3, 4).astype("float16")  # broadcasts to Out, cast
    cases = [(dict(base, **{"Out@GRAD": [g]}), [["X", 0]]),
             (dict(base, **{"Out@GRAD": [None]}), [["X", 0], ["Y", 0]])]
    for ins, diff in cases:
        a = dict(attrs, **{ATTR_DIFF: diff})
        jg = jax_op("elementwise_add_grad").lowering(
            JaxContext(None, None),
            {k: [None if v is None else jnp.asarray(v) for v in vs]
             for k, vs in ins.items()}, dict(a))
        tg = get_op("elementwise_add_grad").lowering(
            LowerContext(None, torch.Generator(), CPU),
            {k: [None if v is None else torch.from_numpy(v) for v in vs]
             for k, vs in ins.items()}, dict(a))
        for slot, i in diff:
            np.testing.assert_allclose(tg[slot + "@GRAD"][i].numpy(),
                                       np.asarray(jg[slot + "@GRAD"][i]),
                                       atol=1e-3, rtol=0)
        if len(diff) == 1:
            assert tg["Y@GRAD"] == [None]
        else:
            assert not tg["X@GRAD"][0].any()  # zero cotangent


def test_pure_context_keeps_device_and_mode_but_no_rng():
    ctx = LowerContext("blk", torch.Generator(), CPU, is_test=True)
    pure = ctx.pure()
    assert (pure.block, pure.device, pure.is_test) == ("blk", CPU, True)
    with pytest.raises(RuntimeError, match="pure context"):
        pure.next_rng()


# ------------------------------------------------------------ whole slice
def _build_train(pkg, bert_mod, cfg=CFG, opt=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = bert_mod.build(cfg, seq_len=S, max_mask=M)
        (opt or pkg.optimizer.Adam)(learning_rate=LR).minimize(loss)
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


def test_both_packages_build_the_same_training_program():
    jmain, jstart, _ = _build_train(jf, jbert)
    tmain, tstart, _ = _build_train(pt, tbert)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fused_attention_grad") == CFG["n_layer"]
    assert types.count("adam") == len(tmain.global_block().all_parameters())


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package: startup, its post-startup scope as numpy, and 5
    Adam steps (losses and final params)."""
    main, startup, loss = _build_train(jf, jbert)
    exe = jf.Executor(jf.CPUPlace())
    scope = jf.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(()))
              for f in _feeds(5)]
    params = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.global_block().all_parameters()}
    return dict(state=state, losses=losses, params=params)


def test_params_from_jax_carries_the_training_scope(jax_run):
    tmain, _, _ = _build_train(pt, tbert)
    state = jax_run["state"]
    names = set(state)
    assert any(n.endswith("_moment1_0") for n in names)
    assert any(n.endswith("_moment2_0") for n in names)
    assert any("beta1_pow" in n for n in names)
    assert any("beta2_pow" in n for n in names)
    assert any(n.startswith("learning_rate") for n in names)
    moved = params_from_jax(state, tmain, CPU)
    assert set(moved) == names
    for n, v in moved.items():
        np.testing.assert_array_equal(v.numpy(), state[n])


def test_port_trains_like_jax_from_a_transplanted_scope(jax_run):
    tmain, _, loss = _build_train(pt, tbert)
    scope = pt.Scope()
    for n, v in params_from_jax(jax_run["state"], tmain, CPU).items():
        scope.set_var(n, v)
    exe = pt.Executor(pt.CPUPlace())
    losses = [float(np.asarray(exe.run(tmain, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(()))
              for f in _feeds(5)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5, atol=0)
    for n, want in jax_run["params"].items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), want,
                                   atol=1e-4, rtol=0, err_msg=n)


def _transplanted(jax_run):
    """The port's training program on a fresh copy of the JAX package's
    post-startup scope: (main, loss, scope)."""
    tmain, _, loss = _build_train(pt, tbert)
    scope = pt.Scope()
    for n, v in params_from_jax(jax_run["state"], tmain, CPU).items():
        scope.set_var(n, v)
    return tmain, loss, scope


def test_tensor_feeds_and_device_fetches_match_numpy_and_jax(jax_run):
    """C1: a torch.Tensor feed takes the same step as its numpy array (and
    as the JAX package's first step on it); ``return_numpy=False`` hands
    back the fetches as tensors on the executor's device."""
    feed = _feeds(5)[0]
    exe = pt.Executor(pt.CPUPlace())
    main, loss, scope = _transplanted(jax_run)
    want = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    main, loss, scope = _transplanted(jax_run)
    got = exe.run(main, feed={k: torch.from_numpy(v) for k, v in
                              feed.items()},
                  fetch_list=[loss], scope=scope, return_numpy=False)
    assert all(isinstance(v, torch.Tensor) and v.device == CPU
               for v in got)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(float(want[0].reshape(())),
                               jax_run["losses"][0], rtol=1e-5, atol=0)


def test_tensor_feeds_narrow_int64_and_cast_to_the_var_dtype(jax_run):
    """C1: an int64 tensor feed narrows to int32 with the numpy path's
    range check; a float64 tensor fed to a float32 var is cast."""
    from paddle_tpu_torch.core.executor import feed_to_device

    main, loss, scope = _transplanted(jax_run)
    block = main.global_block()
    ids = torch.full((B, S), 2 ** 31, dtype=torch.int64)
    with pytest.raises(OverflowError, match="outside the device int32"):
        feed_to_device("src_ids", ids, block.var("src_ids"), CPU)
    feed = dict(_feeds(5)[0])
    with pytest.raises(OverflowError, match="src_ids"):
        pt.Executor(pt.CPUPlace()).run(
            main, feed=dict(feed, src_ids=ids), fetch_list=[loss],
            scope=scope)
    small = feed_to_device("src_ids", torch.from_numpy(feed["src_ids"]),
                           block.var("src_ids"), CPU)
    assert small.dtype == torch.int32
    np.testing.assert_array_equal(small.numpy(), feed["src_ids"])
    mask64 = torch.from_numpy(feed["input_mask"].astype("float64") / 3)
    cast = feed_to_device("input_mask", mask64, block.var("input_mask"),
                          CPU)
    assert cast.dtype == torch.float32
    np.testing.assert_array_equal(cast.numpy(),
                                  (feed["input_mask"].astype("float64")
                                   / 3).astype("float32"))


def _port_losses(steps, feed):
    cfg = dict(CFG, dropout=0.1)
    main, startup, loss = _build_train(pt, tbert, cfg)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    return [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]).reshape(()))
            for _ in range(steps)]


def test_port_training_with_dropout_is_repeatable_and_learns():
    feed = _feeds(1, seed=3)[0]
    first = _port_losses(20, feed)
    assert _port_losses(20, feed) == first  # bitwise, dropout included
    assert np.isfinite(first).all()
    assert first[-1] < 0.7 * first[0]


def test_a_step_replays_bitwise_from_a_scope_snapshot():
    """The executor replaces scope values and never updates them in
    place, the RNG state included: a snapshot replays the same step."""
    main, startup, loss = _build_train(pt, tbert, dict(CFG, dropout=0.1))
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _feeds(1, seed=4)[0]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    snap = {n: scope.find_var(n) for n in scope.local_var_names()}
    runs = []
    for _ in range(2):
        sc = pt.Scope()
        for n, v in snap.items():
            sc.set_var(n, v)
        (val,) = exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
        runs.append((val, {n: sc.find_var(n) for n in snap}))
    assert runs[0][0] == runs[1][0]
    for n in snap:
        v0, v1 = runs[0][1][n], runs[1][1][n]
        if isinstance(v0, torch.Tensor):
            assert torch.equal(v0, v1), n
        else:  # the RNG chain
            assert torch.equal(v0.get_state(), v1.get_state())


def test_other_optimizers_build_and_sgd_momentum_run():
    feed = _feeds(1, seed=5)[0]
    for opt in (pt.optimizer.SGD, pt.optimizer.Momentum):
        kw = {"momentum": 0.9} if opt is pt.optimizer.Momentum else {}
        main, startup, loss = _build_train(
            pt, tbert, opt=lambda learning_rate, _o=opt, _kw=kw:
            _o(learning_rate=learning_rate, **_kw))
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        ls = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
              for _ in range(3)]
        assert np.isfinite(ls).all()
    # the other optimizers' update ops are ported
    # (tests/test_torch_optimizer_ops.py holds them against the JAX
    # package): Adagrad's program runs
    main, startup, loss = _build_train(pt, tbert, opt=pt.optimizer.Adagrad)
    assert "adagrad" in {op.type for op in main.global_block().ops}
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    ls = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
          for _ in range(3)]
    assert np.isfinite(ls).all()
    # an op type with no lowering (the port lowers every op type of the
    # JAX package's since the parameter-server tier; listen_and_serv is
    # the pserver loop's entry, which no package lowers) builds, and its
    # run says so: the prepare-time verifier (PADDLE_TPU_VALIDATE=1
    # under the tests) or, without it, the block analysis
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4], dtype="float32")
        y = main.global_block().create_var(name="sent", dtype="float32",
                                           shape=[-1, 4])
        main.global_block().append_op(type="scale", inputs={"X": [x]},
                                      outputs={"Out": [y]})
        main.global_block().append_op(type="listen_and_serv",
                                      inputs={"X": [y]},
                                      outputs={"Out": [y]})
    assert "listen_and_serv" not in OPS
    with pytest.raises((KeyError, ProgramVerifyError),
                       match="'listen_and_serv' has no registered "
                             "lowering"):
        exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                fetch_list=[y], scope=scope)


def test_global_norm_clip_and_l2_decay_train():
    from paddle_tpu_torch import clip, regularizer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = tbert.build(CFG, seq_len=S, max_mask=M)
        clip.set_gradient_clip(clip.GradientClipByGlobalNorm(0.5))
        try:
            pt.optimizer.Adam(
                learning_rate=LR,
                regularization=regularizer.L2Decay(1e-4)).minimize(loss)
        finally:
            clip.set_gradient_clip(None)
    types = {op.type for op in main.global_block().ops}
    assert {"squared_l2_norm", "sqrt", "elementwise_max"} <= types
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = _feeds(1, seed=6)[0]
    ls = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0]).reshape(()))
          for _ in range(4)]
    assert np.isfinite(ls).all() and ls[-1] < ls[0]
