"""The edge cases of the ops transformer and GPT add to the port, each
against the JAX package's lowering on the same numpy inputs, and the
repair of C8 (an id past a table's rows).

One case per op and its grad live in tests/test_torch_ops.py and
tests/test_torch_training.py, whose coverage tests want a case for every
registered op; this file holds what those do not: ``slice``'s clamping,
``one_hot`` with ids outside [0, depth), ``matmul``'s 1-D and broadcast
rules, ``rope`` with [S], [1] and [B, S] positions, ``kv_cache_write``
lockstep, per row and with a clamped overflow, and ``rms_norm`` /
``rope`` at AMP's dtypes.

C8: an id past the rows of ``lookup_table`` or ``gather`` gives a NaN
row, as ``jnp.take``'s fill mode does (an id in [-n, 0) wraps), and the
grads drop it, as JAX's scatter does; the port used to raise IndexError
on the CPU (and fail a device assert on the card).

Tolerances: exact for copies, shape ops, one-hot and integer work; 1e-5
for products and f32 transcendentals (another math library); bf16
results to one bf16 ulp of their magnitude (2**-7 relative): XLA on the
CPU and torch round the same f32 values, but sin / cos / rsqrt feed
them from two libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.core.autodiff import ATTR_DIFF, ATTR_FWD_IN, \
    ATTR_FWD_OUT
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import get_op

CPU = torch.device("cpu")


def _arr(rs, shape, dtype="float32"):
    if np.dtype(dtype).kind in "iu":
        return rs.randint(0, 10, shape).astype(dtype)
    return rs.randn(*shape).astype(dtype)


def _lower_both(op_type, ins, attrs, bf16=()):
    """(jax outputs, port outputs), each {slot: [numpy]}; the slots in
    ``bf16`` enter both packages as bfloat16, outputs come back as f32."""
    def j_in(slot, v):
        a = jnp.asarray(v)
        return a.astype(jnp.bfloat16) if slot in bf16 else a

    def t_in(slot, v):
        t = torch.from_numpy(np.array(v))
        return t.to(torch.bfloat16) if slot in bf16 else t

    j = jax_op(op_type).lowering(
        JaxContext(None, None),
        {k: [j_in(k, v) for v in vs] for k, vs in ins.items()}, dict(attrs))
    t = get_op(op_type).lowering(
        LowerContext(None, None, CPU),
        {k: [t_in(k, v) for v in vs] for k, vs in ins.items()}, dict(attrs))

    def j_np(x):
        return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                          else x)

    def t_np(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return ({k: [j_np(x) for x in v] for k, v in j.items()},
            {k: [t_np(x) for x in v] for k, v in t.items()},
            {k: [str(x.dtype) for x in v] for k, v in j.items()},
            {k: [str(x.dtype) for x in v] for k, v in t.items()})


def _check(op_type, ins, attrs, atol, rtol=0.0, bf16=()):
    j, t, jd, td = _lower_both(op_type, ins, attrs, bf16)
    for slot in j:
        for a, b, da, db in zip(j[slot], t[slot], jd[slot], td[slot]):
            assert a.shape == b.shape, (op_type, slot, a.shape, b.shape)
            assert da == db.replace("torch.", ""), (op_type, slot, da, db)
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg="%s.%s" % (op_type, slot))
    return j, t


# ------------------------------------------------------------------ slice
@pytest.mark.parametrize("starts,ends", [
    ([-100], [3]), ([2], [100]), ([-3], [-1]), ([5], [2]), ([8], [9]),
    ([0], [-100])])
def test_slice_clamps_starts_and_ends_as_the_jax_package(starts, ends):
    x = _arr(np.random.RandomState(0), (3, 8))
    _check("slice", {"Input": [x]}, {"axes": [1], "starts": starts,
                                     "ends": ends}, 0)


# ---------------------------------------------------------------- one_hot
def test_one_hot_gives_zero_rows_outside_the_depth():
    """``jax.nn.one_hot``'s rule: an id outside [0, depth), -1 included,
    gives an all-zero row (``F.one_hot`` would raise); int32 ids, as the
    card holds them."""
    ids = np.array([[0], [6], [7], [12], [-1], [3]], "int32")
    j, t = _check("one_hot", {"X": [ids]}, {"depth": 7}, 0)
    out = t["Out"][0]
    assert out.shape == (6, 7)
    assert (out[[2, 3, 4]] == 0).all() and out[1, 6] == 1


# ----------------------------------------------------------------- matmul
@pytest.mark.parametrize("xs,ys,attrs", [
    ((5,), (5, 3), {}),                                # 1-D X: a row
    ((4,), (3, 4), {"transpose_Y": True}),
    ((5,), (5, 3), {"transpose_X": True}),            # [5, 1], transposed
    ((2, 5), (5,), {}),                                # 1-D Y: a vector
    ((2, 5), (5,), {"transpose_Y": True}),            # Y 1-D: no transpose
    ((5,), (5,), {}),
    ((2, 1, 3, 4), (5, 4, 6), {"alpha": 0.5}),         # broadcast batch
    ((3, 4, 5), (5, 6), {}),
    ((2, 3, 4, 5), (2, 3, 4, 6), {"transpose_X": True, "alpha": 3.0}),
])
def test_matmul_rank_and_broadcast_rules(xs, ys, attrs):
    rs = np.random.RandomState(1)
    _check("matmul", {"X": [_arr(rs, xs)], "Y": [_arr(rs, ys)]}, attrs, 1e-5)


def test_matmul_alpha_is_a_weak_scalar_under_bf16():
    rs = np.random.RandomState(2)
    _check("matmul", {"X": [_arr(rs, (4, 8))], "Y": [_arr(rs, (8, 3))]},
           {"alpha": 0.3}, 0.02, 2 ** -7, bf16=("X", "Y"))


# ------------------------------------------------------------------- rope
@pytest.mark.parametrize("pos_shape", ["S", "one", "BS"])
def test_rope_positions_as_s_one_and_b_s(pos_shape):
    rs = np.random.RandomState(3)
    x = _arr(rs, (2, 3, 6, 8))
    pos = {"S": np.arange(6) + 2, "one": np.array([9]),
           "BS": np.stack([np.arange(6), np.array([0, 1, 2, 0, 1, 2])])
           }[pos_shape].astype("int32")
    _check("rope", {"X": [x], "Pos": [pos]}, {}, 1e-5)
    # the decode step's fold: [B, Hkv, g, D] queries at a [B, 1] position
    if pos_shape == "BS":
        _check("rope", {"X": [x], "Pos": [np.array([[3], [7]], "int32")]},
               {}, 1e-5)


def test_rope_with_row_positions_needs_a_4d_x():
    x = _arr(np.random.RandomState(4), (2, 6, 8))
    pos = np.zeros((2, 6), "int32")
    with pytest.raises(ValueError, match="needs a \\[B, H, S, D\\]"):
        jax_op("rope").lowering(JaxContext(None, None),
                                {"X": [jnp.asarray(x)],
                                 "Pos": [jnp.asarray(pos)]}, {})
    with pytest.raises(ValueError, match="needs a \\[B, H, S, D\\]"):
        get_op("rope").lowering(LowerContext(None, None, CPU),
                                {"X": [torch.from_numpy(x)],
                                 "Pos": [torch.from_numpy(pos)]}, {})


def test_rope_at_bf16_casts_sin_and_cos_first():
    x = _arr(np.random.RandomState(5), (2, 2, 6, 16)) * 4
    _check("rope", {"X": [x], "Pos": [np.arange(6).astype("int32") * 7]},
           {}, 0.02, 2 ** -7, bf16=("X",))


# --------------------------------------------------------------- rms_norm
def test_rms_norm_at_amp_dtypes():
    """Under AMP rms_norm keeps its input dtypes: a bf16 x with an f32
    scale gives an f32 result (bf16 x f32 promotes in both packages),
    from f32 statistics."""
    rs = np.random.RandomState(6)
    x = _arr(rs, (2, 5, 16)) * 3
    scale = _arr(rs, (16,))
    _check("rms_norm", {"X": [x], "Scale": [scale]},
           {"begin_norm_axis": 2}, 0.02, 2 ** -7, bf16=("X",))
    _, _, jd, td = _lower_both("rms_norm", {"X": [x], "Scale": [scale]},
                                 {"begin_norm_axis": 2}, bf16=("X",))
    assert jd["Y"] == ["float32"] and td["Y"] == ["torch.float32"]
    _check("rms_norm", {"X": [x], "Scale": [scale]},
           {"begin_norm_axis": 2}, 0.02, 2 ** -7, bf16=("X", "Scale"))


# --------------------------------------------------------- kv_cache_write
@pytest.mark.parametrize("pos,u", [
    (np.array([3], "int32"), 1),            # lockstep
    (np.array([6], "int32"), 2),            # the last rows
    (np.array([7], "int32"), 3),            # overflow: start clamps to 5
    (np.array([-4], "int32"), 2),           # negative: counts from the end
    (np.array([-11], "int32"), 1),          # once, then clamps to 0
    (np.array([1, 7], "int32"), 1),         # per row, [B]
    (np.array([[0], [9]], "int32"), 2),     # per row, [B, 1], one clamped
])
def test_kv_cache_write_as_dynamic_update_slice(pos, u):
    rs = np.random.RandomState(7)
    cache = _arr(rs, (2, 3, 8, 4))
    upd = _arr(rs, (2, 3, u, 4))
    ins = {"Cache": [cache], "Update": [upd], "Pos": [pos]}
    _check("kv_cache_write", ins, {}, 0)
    # the port writes the cache tensor it was given, in place
    c = torch.from_numpy(cache.copy())
    out = get_op("kv_cache_write").lowering(
        LowerContext(None, None, CPU),
        {"Cache": [c], "Update": [torch.from_numpy(upd)],
         "Pos": [torch.from_numpy(pos)]}, {})["Out"][0]
    assert out is c and not np.array_equal(c.numpy(), cache)


def test_kv_cache_write_casts_the_update_to_the_cache_dtype():
    rs = np.random.RandomState(8)
    _check("kv_cache_write", {"Cache": [_arr(rs, (1, 2, 4, 8))],
                              "Update": [_arr(rs, (1, 2, 1, 8))],
                              "Pos": [np.array([2], "int32")]}, {}, 0,
           bf16=("Update",))


# -------------------------------------------------------------------- C8
OOB = [0, 7, 7 + 5, -1, 3, -7, -8, 2]  # rows = 7: id 7, 12 and -8 miss


def _grads_both(op_type, ins, attrs, diff, rs):
    """``<op_type>_grad`` in both packages on the JAX package's forward
    outputs and one random output cotangent (numpy)."""
    j_ins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    fwd = jax_op(op_type).lowering(JaxContext(None, jax.random.PRNGKey(0)),
                                   j_ins, dict(attrs))
    outs = {k: [np.asarray(v) for v in vs] for k, vs in fwd.items()}
    cots = {k + "@GRAD": [rs.randn(*v.shape).astype(v.dtype) for v in vs]
            for k, vs in outs.items()}
    gattrs = dict(attrs)
    gattrs[ATTR_FWD_IN] = {k: len(v) for k, v in ins.items()}
    gattrs[ATTR_FWD_OUT] = {k: len(v) for k, v in outs.items()}
    gattrs[ATTR_DIFF] = [list(d) for d in diff]
    gins = dict(ins, **outs, **cots)
    jg = jax_op(op_type + "_grad").lowering(
        JaxContext(None, None),
        {k: [jnp.asarray(v) for v in vs] for k, vs in gins.items()},
        dict(gattrs))
    tg = get_op(op_type + "_grad").lowering(
        LowerContext(None, None, CPU),
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in gins.items()}, dict(gattrs))
    return jg, tg


@pytest.mark.parametrize("op_type", ["lookup_table", "gather"])
def test_ids_past_the_rows_give_nan_rows_and_no_grad(op_type):
    """C8: ids = rows, rows + 5 and -(rows + 1) give NaN rows, -1 wraps to
    the last row; the grad drops the rows no id reaches, in both
    packages."""
    rs = np.random.RandomState(9)
    w = _arr(rs, (7, 4))
    ids = np.array(OOB, "int32")
    if op_type == "lookup_table":
        ins, attrs, slot = {"W": [w], "Ids": [ids.reshape(2, 4, 1)]}, \
            {"padding_idx": -1}, "W"
    else:
        ins, attrs, slot = {"X": [w], "Index": [ids]}, {}, "X"
    j, t = _check(op_type, ins, attrs, 0)
    out = t["Out"][0].reshape(-1, 4)
    miss = [i for i, v in enumerate(OOB) if not -7 <= v < 7]
    assert np.isnan(out[miss]).all()
    assert np.isfinite(np.delete(out, miss, axis=0)).all()
    np.testing.assert_array_equal(out[3], w[6])  # -1 wraps
    jg, tg = _grads_both(op_type, ins, attrs, [(slot, 0)], rs)
    np.testing.assert_allclose(tg[slot + "@GRAD"][0].numpy(),
                               np.asarray(jg[slot + "@GRAD"][0]),
                               atol=1e-6, rtol=0)


def test_gather_past_the_rows_on_another_axis():
    x = _arr(np.random.RandomState(10), (2, 5, 3))
    _check("gather", {"X": [x], "Index": [np.array([4, 5, -1, -6],
                                                   "int32")]},
           {"axis": 1}, 0)


def test_an_id_past_the_table_runs_through_a_program():
    """C8 end to end: a training step whose batch holds an id past the
    vocabulary runs, its lookup rows are NaN, and the table's grad (the
    generic backward of the program) holds only the other ids' rows."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        ids = pt.layers.data("ids", [3], dtype="int64")
        emb = pt.layers.embedding(ids, [6, 4],
                                  param_attr=pt.ParamAttr(name="emb"))
        loss = pt.layers.reduce_sum(emb)
        append_backward(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"ids": np.array([[1, 6, 2], [11, 1, -1]], "int64")}
    out, g = exe.run(main, feed=feed, fetch_list=[emb, "emb@GRAD"],
                     scope=scope)
    assert np.isnan(out[0, 1]).all() and np.isnan(out[1, 0]).all()
    assert np.isfinite(out[0, [0, 2]]).all()
    want = np.zeros((6, 4), "float32")
    for i in (1, 2, 1, 5):
        want[i] += 1.0
    np.testing.assert_array_equal(g, want)
