"""The sequence ops (paddle_tpu_torch/ops/sequence.py) against the JAX
package's on the CPU: every op of the module, its grad where it has
one, each ``pool_type``, on ragged lengths that hold 1 and T, all 1 and
all T, and the layers that build them (layers/sequence.py, a copy) in a
program run by both executors.

Tolerances: exact for the copies, gathers and integer ops (``reverse``,
``expand``, ``pad``, ``unpad``, ``concat``, ``slice``, ``enumerate``,
``erase``, ``mask``); atol 1e-6 for the masked pools and
``sequence_softmax``; 1e-5 for ``sequence_conv`` and ``row_conv``
(f32 products summed in another order) and for the programs with fc
layers. Grads: the generic vjp in both packages, at the forward's
tolerance (1e-6 where the forward is exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.autodiff import ATTR_DIFF, ATTR_FWD_IN, ATTR_FWD_OUT
from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import get_op
from torch_parity import assert_runs_close, run_both

CPU = torch.device("cpu")
T = 6
LENGTHS = {"ragged": [1, 6, 3, 5], "all_one": [1, 1, 1, 1],
           "all_T": [6, 6, 6, 6]}


def _arr(rs, shape):
    return rs.randn(*shape).astype("float32")


def _lens(kind):
    return np.array(LENGTHS[kind], "int32")


def _jax_ins(ins):
    return {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}


def _torch_ins(ins):
    return {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}


def _check(op, ins, attrs, atol, grad_wrt=()):
    """Forward outputs, then (for the slots in ``grad_wrt``) the grads
    under one random cotangent per float output."""
    j = jax_op(op).lowering(JaxContext(None, None), _jax_ins(ins),
                            dict(attrs))
    t = get_op(op).lowering(LowerContext(None, None, CPU), _torch_ins(ins),
                            dict(attrs))
    for slot, vs in j.items():
        for a, b in zip(vs, t[slot]):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (op, slot)
            np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                       err_msg="%s %s" % (op, slot))
    if not grad_wrt:
        return
    rs = np.random.RandomState(7)
    outs = {k: [np.asarray(v) for v in vs] for k, vs in j.items()}
    cots = {k + "@GRAD": [_arr(rs, v.shape) for v in vs]
            for k, vs in outs.items()
            if all(v.dtype.kind == "f" for v in vs)}
    diff = [[s, 0] for s in grad_wrt]
    gattrs = dict(attrs, **{ATTR_FWD_IN: {k: len(v) for k, v in ins.items()},
                            ATTR_FWD_OUT: {k: len(v) for k, v in
                                           outs.items()},
                            ATTR_DIFF: diff})
    gins = dict(ins, **outs, **cots)
    jg = jax_op(op + "_grad").lowering(JaxContext(None, None),
                                       _jax_ins(gins), dict(gattrs))
    tg = get_op(op + "_grad").lowering(LowerContext(None, None, CPU),
                                       _torch_ins(gins), dict(gattrs))
    for s in grad_wrt:
        np.testing.assert_allclose(
            tg[s + "@GRAD"][0].numpy(), np.asarray(jg[s + "@GRAD"][0]),
            atol=max(atol, 1e-6), rtol=0, err_msg="%s %s@GRAD" % (op, s))


@pytest.mark.parametrize("kind", sorted(LENGTHS))
@pytest.mark.parametrize("ptype", ["average", "sum", "sqrt", "max", "last",
                                   "first"])
def test_sequence_pool_each_type(kind, ptype):
    rs = np.random.RandomState(0)
    _check("sequence_pool", {"X": [_arr(rs, (4, T, 3))],
                             "Length": [_lens(kind)]},
           {"pool_type": ptype}, 1e-6, grad_wrt=["X"])


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_masked_ops_and_grads(kind):
    rs = np.random.RandomState(1)
    L = _lens(kind)
    x = _arr(rs, (4, T, 2))
    _check("sequence_softmax", {"X": [_arr(rs, (4, T))], "Length": [L]}, {},
           1e-6, grad_wrt=["X"])
    _check("sequence_reverse", {"X": [x], "Length": [L]}, {}, 0,
           grad_wrt=["X"])
    _check("sequence_unpad", {"X": [x], "Length": [L]}, {}, 0,
           grad_wrt=["X"])
    _check("sequence_pad", {"X": [x], "Length": [L],
                            "PadValue": [np.array([-2.0], "float32")]}, {},
           0, grad_wrt=["X"])
    for ctx_len, start in ((3, -1), (1, 0), (5, -4)):
        _check("sequence_conv", {"X": [x], "Filter": [_arr(rs, (ctx_len * 2,
                                                                4))],
                                 "Length": [L]},
               {"context_length": ctx_len, "context_start": start}, 1e-5,
               grad_wrt=["X", "Filter"])


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_concat_slice_and_expand(kind):
    rs = np.random.RandomState(2)
    L = _lens(kind)
    other = np.array([2, 1, 4, 3], "int32")
    _check("sequence_concat", {"X": [_arr(rs, (4, T, 2)),
                                     _arr(rs, (4, 4, 2))],
                               "Length": [L, other]}, {}, 0,
           grad_wrt=["X"])
    offset = np.minimum(np.array([0, 2, 1, 3]), L - 1).reshape(-1, 1)
    _check("sequence_slice", {"X": [_arr(rs, (4, T, 2))],
                              "Offset": [offset.astype("int32")],
                              "SliceLength": [(L.reshape(-1, 1) - offset)
                                              .astype("int32")]},
           {}, 0, grad_wrt=["X"])
    _check("sequence_expand", {"X": [_arr(rs, (4, 3))],
                               "Y": [_arr(rs, (4, 3, 3))]}, {}, 0,
           grad_wrt=["X"])
    _check("sequence_expand_as", {"X": [_arr(rs, (2, 3))],
                                  "Y": [_arr(rs, (8, 3))]}, {}, 0,
           grad_wrt=["X"])
    _check("sequence_mask", {"X": [L]}, {"maxlen": T, "out_dtype": "bool"},
           0)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_integer_ops(kind):
    rs = np.random.RandomState(3)
    L = _lens(kind)
    ids = rs.randint(0, 5, (4, T)).astype("int32")
    for win, pad in ((1, 0), (3, 9), (T + 1, -1)):
        _check("sequence_enumerate", {"X": [ids], "Length": [L]},
               {"win_size": win, "pad_value": pad}, 0)
    for tokens in ([], [0], [1, 3], [0, 1, 2, 3, 4]):
        _check("sequence_erase", {"X": [ids], "Length": [L]},
               {"tokens": tokens}, 0)


def test_row_conv_and_its_grad():
    rs = np.random.RandomState(4)
    for k in (1, 3, T + 2):
        _check("row_conv", {"X": [_arr(rs, (2, T, 3))],
                            "Filter": [_arr(rs, (k, 3))]}, {}, 1e-5,
               grad_wrt=["X", "Filter"])


def test_sequence_layers_run_like_the_jax_package():
    """layers/sequence.py's builders in one program: pool, conv, reverse,
    first and last step, softmax, the mask and padding."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [T, 4])
        ln = L.data("len", [], dtype="int64")
        ids = L.data("ids", [T], dtype="int64")
        return [L.sequence_pool(x, "max", length=ln),
                L.sequence_conv(x, num_filters=6, filter_size=3, length=ln),
                L.sequence_reverse(x, length=ln),
                L.sequence_first_step(x, length=ln),
                L.sequence_last_step(x, length=ln),
                L.sequence_softmax(L.reduce_sum(x, dim=2), length=ln),
                L.sequence_mask(ln, maxlen=T),
                L.sequence_unpad(x, length=ln),
                L.sequence_enumerate(ids, 2, length=ln),
                L.sequence_erase(ids, [1, 2], length=ln)[0],
                L.row_conv(x, future_context_size=2)]

    rs = np.random.RandomState(5)
    feeds = [{"x": _arr(rs, (4, T, 4)),
              "len": np.array(LENGTHS[k], "int64"),
              "ids": rs.randint(0, 4, (4, T)).astype("int64")}
             for k in sorted(LENGTHS)]
    jres, tres, _, _ = run_both(build, feeds)
    assert_runs_close(jres, tres, 1e-5)


def test_sequence_model_trains_like_the_jax_package():
    """An embedding -> sequence_conv -> sequence_pool classifier, 3 Adam
    steps: losses to a relative 1e-5."""
    def build(pkg):
        L = pkg.layers
        ids = L.data("ids", [T], dtype="int64")
        ln = L.data("len", [], dtype="int64")
        lbl = L.data("lbl", [1], dtype="int64")
        emb = L.embedding(ids, size=[20, 8])
        conv = L.sequence_conv(emb, num_filters=8, filter_size=3, length=ln,
                               act="tanh")
        pooled = L.sequence_pool(conv, "average", length=ln)
        probs = L.fc(pooled, size=3, act="softmax")
        loss = L.mean(L.cross_entropy(probs, lbl))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss]

    rs = np.random.RandomState(6)
    feed = {"ids": rs.randint(0, 20, (4, T)).astype("int64"),
            "len": np.array(LENGTHS["ragged"], "int64"),
            "lbl": rs.randint(0, 3, (4, 1)).astype("int64")}
    jres, tres, _, _ = run_both(build, [feed] * 3)
    assert_runs_close(jres, tres, 0, rtol=1e-5)
    assert tres[2][0] < tres[0][0]

