"""The loss ops and layers/loss.py, and the op tail's edges, in the port
against the JAX package (and, where the JAX package is not the oracle,
against a direct computation) on the CPU.

Tolerances: the scans (warpctc, linear_chain_crf: values and grads)
atol 1e-5 plus rtol 1e-6, as the recurrent ops' cases; nce's cost and
grads 1e-5 plus rtol 1e-6; the brute-force sums over every path
(CTC, the CRF's partition function) 1e-4 (float64 sums of exp against
the ops' f32 log space); crf_decoding, edit_distance's counts and the
integer ops exactly; hierarchical_sigmoid 1e-5. The random ops draw
from another generator than the JAX package's, so they are pinned
within the port: the same chain gives the same draw, a nonzero ``seed``
attr the same draw whatever the chain, and the range and moments
hold.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.autodiff import ATTR_DIFF, ATTR_FWD_IN, \
    ATTR_FWD_OUT
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import get_op

CPU = torch.device("cpu")
SCAN = dict(atol=1e-5, rtol=1e-6)
LENGTHS = np.array([0, 1, 6, 3], "int32")  # [0, 1, T, 3] at T = 6


def _port(op_type, ins, attrs, chain=None):
    ctx = LowerContext(None, chain, CPU)
    return get_op(op_type).lowering(
        ctx, {k: [None if v is None else torch.from_numpy(np.array(v))
                  for v in vs] for k, vs in ins.items()}, dict(attrs))


def _jax(op_type, ins, attrs):
    return jax_op(op_type).lowering(
        JaxContext(None, jax.random.PRNGKey(0)),
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))


def _port_grad(op_type, ins, outs, cots, attrs, diff):
    """The port's ``<op>_grad`` on numpy forward inputs, outputs and
    output cotangents."""
    gattrs = dict(attrs)
    gattrs[ATTR_FWD_IN] = {k: len(v) for k, v in ins.items()}
    gattrs[ATTR_FWD_OUT] = {k: len(v) for k, v in outs.items()}
    gattrs[ATTR_DIFF] = [list(d) for d in diff]
    gins = dict(ins, **outs, **cots)
    return get_op(op_type + "_grad").lowering(
        LowerContext(None, None, CPU),
        {k: [None if v is None else torch.from_numpy(np.array(v))
             for v in vs] for k, vs in gins.items()}, gattrs)


# ---------------------------------------------------------------- nce
@pytest.mark.parametrize("bias", [True, False])
def test_nce_against_the_jax_loss_on_the_ports_sample_labels(bias):
    from paddle_tpu.ops.loss_ops import _nce_loss

    rs = np.random.RandomState(3)
    x, w, b = (rs.randn(5, 6).astype("float32"),
               rs.randn(20, 6).astype("float32"),
               rs.randn(20).astype("float32"))
    label = np.array([[3], [0], [19], [3], [7]], "int32")
    ins = {"Input": [x], "Weight": [w], "Label": [label]}
    if bias:
        ins["Bias"] = [b]
    attrs = {"num_neg_samples": 8, "num_total_classes": 20}
    out = _port("nce", ins, attrs, torch.Generator().manual_seed(1))
    ids = out["SampleLabels"][0].numpy()
    assert ids.dtype == np.int32 and ids.shape == (5, 9)
    np.testing.assert_array_equal(ids[:, 0], label[:, 0])
    assert ((ids >= 0) & (ids < 20)).all()
    # another chain draws other negatives, the same chain the same
    again = _port("nce", ins, attrs, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(again["SampleLabels"][0].numpy(), ids)
    other = _port("nce", ins, attrs, torch.Generator().manual_seed(2))
    assert not np.array_equal(other["SampleLabels"][0].numpy(), ids)

    primals = (x, w, b) if bias else (x, w)
    cost, vjp = jax.vjp(lambda *p: _nce_loss(
        p[0], p[1], p[2] if bias else None, jnp.asarray(ids), 8, 20)[0],
        *primals)
    np.testing.assert_allclose(out["Cost"][0].numpy(), np.asarray(cost),
                               **SCAN)
    dcost = rs.randn(5, 1).astype("float32")
    want = vjp(jnp.asarray(dcost))
    outs = {k: [v.numpy()] for k, v in
            ((k, vs[0]) for k, vs in out.items())}
    diff = [("Input", 0), ("Weight", 0)] + ([("Bias", 0)] if bias else [])
    got = _port_grad("nce", ins, outs, {"Cost@GRAD": [dcost]}, attrs, diff)
    for (slot, _), w_ in zip(diff, want):
        np.testing.assert_allclose(got[slot + "@GRAD"][0].numpy(),
                                   np.asarray(w_), err_msg=slot, **SCAN)
    assert got["Label@GRAD"] == [None]
    if not bias:
        assert got["Bias@GRAD"] == [None]


# ------------------------------------------------------------- the CRF
def _crf(rs, C=3, T=6, B=4):
    return (rs.randn(B, T, C).astype("float32"),
            (rs.randn(C + 2, C) * 0.5).astype("float32"),
            rs.randint(0, C, (B, T)).astype("int32"))


def test_linear_chain_crf_lengths_values_and_grads():
    rs = np.random.RandomState(4)
    em, tr, lab = _crf(rs)
    ins = {"Emission": [em], "Transition": [tr], "Label": [lab],
           "Length": [LENGTHS]}
    j = _jax("linear_chain_crf", ins, {})
    t = _port("linear_chain_crf", ins, {})
    np.testing.assert_allclose(t["LogLikelihood"][0].numpy(),
                               np.asarray(j["LogLikelihood"][0]), **SCAN)
    # grads: the JAX package's vjp of its scan against the port's of its
    # loop, on one cotangent
    g = rs.randn(4, 1).astype("float32")
    _, vjp = jax.vjp(lambda e, w: jax_op("linear_chain_crf").lowering(
        JaxContext(None, None), {"Emission": [e], "Transition": [w],
                                 "Label": [jnp.asarray(lab)],
                                 "Length": [jnp.asarray(LENGTHS)]}, {})[
        "LogLikelihood"][0], jnp.asarray(em), jnp.asarray(tr))
    want = vjp(jnp.asarray(g))
    got = _port_grad("linear_chain_crf", ins,
                     {"LogLikelihood": [t["LogLikelihood"][0].numpy()],
                      "Alpha": [None], "EmissionExps": [None],
                      "TransitionExps": [None]},
                     {"LogLikelihood@GRAD": [g]}, {},
                     [("Emission", 0), ("Transition", 0)])
    for slot, w_ in zip(("Emission", "Transition"), want):
        np.testing.assert_allclose(got[slot + "@GRAD"][0].numpy(),
                                   np.asarray(w_), err_msg=slot, **SCAN)
    # a row of length 0 or 1 takes no grad from the steps past it
    e_grad = got["Emission@GRAD"][0].numpy()
    assert not e_grad[1, 1:].any() and not e_grad[3, 3:].any()


def test_linear_chain_crf_is_the_log_probability_of_the_gold_path():
    """exp(LogLikelihood) against the gold path's score over the sum of
    every path's (brute force, float64), lengths 1 to 3."""
    rs = np.random.RandomState(5)
    C = 3
    em, tr, lab = _crf(rs, C=C, T=3, B=3)
    length = np.array([1, 2, 3], "int32")
    ll = _port("linear_chain_crf", {"Emission": [em], "Transition": [tr],
                                    "Label": [lab], "Length": [length]},
               {})["LogLikelihood"][0].numpy()[:, 0]
    start, stop, trans = (tr[0].astype(np.float64), tr[1].astype(np.float64),
                          tr[2:].astype(np.float64))

    def score(b, path):
        s = start[path[0]] + stop[path[-1]]
        s += sum(em[b, t, k] for t, k in enumerate(path))
        s += sum(trans[a, c] for a, c in zip(path, path[1:]))
        return s

    for b, n in enumerate(length):
        z = sum(np.exp(score(b, p)) for p in itertools.product(range(C),
                                                                repeat=n))
        np.testing.assert_allclose(ll[b], score(b, lab[b, :n]) - np.log(z),
                                   atol=1e-4)


def test_crf_decoding_lengths_and_ties_match_the_jax_package():
    rs = np.random.RandomState(6)
    em, tr, _ = _crf(rs, C=4)
    for e, t in ((em, tr), (np.round(em), np.round(tr)),
                 (np.zeros_like(em), np.zeros_like(tr))):
        ins = {"Emission": [e], "Transition": [t], "Length": [LENGTHS]}
        j = np.asarray(_jax("crf_decoding", ins, {})["ViterbiPath"][0])
        p = _port("crf_decoding", ins, {})["ViterbiPath"][0].numpy()
        assert p.dtype == np.int32
        np.testing.assert_array_equal(p, j)
        # past each row's length: 0
        for b, n in enumerate(LENGTHS):
            assert not p[b, n:].any()
    # all scores equal: every step takes the first tag
    assert not p.any()


def test_crf_decoding_finds_the_best_path():
    rs = np.random.RandomState(7)
    C = 3
    em, tr, _ = _crf(rs, C=C, T=4, B=2)
    path = _port("crf_decoding", {"Emission": [em], "Transition": [tr],
                                  "Length": [np.array([4, 3], "int32")]},
                 {})["ViterbiPath"][0].numpy()
    start, stop, trans = tr[0], tr[1], tr[2:]
    for b, n in enumerate((4, 3)):
        def score(p):
            return (start[p[0]] + stop[p[-1]]
                    + sum(em[b, t, k] for t, k in enumerate(p))
                    + sum(trans[a, c] for a, c in zip(p, p[1:])))

        best = max(itertools.product(range(C), repeat=n), key=score)
        np.testing.assert_array_equal(path[b, :n], best)


# ------------------------------------------------------------- CTC
def _ctc_ins(rs, label_len, logit_len, T=6, C=5, L=3, blank=0):
    label = rs.randint(1, C, (len(label_len), L)).astype("int32")
    if blank:
        label = np.where(label == blank, 0, label).astype("int32")
    return {"Logits": [(rs.randn(len(label_len), T, C) * 2)
                       .astype("float32")],
            "Label": [label],
            "LogitsLength": [np.array(logit_len, "int32")],
            "LabelLength": [np.array(label_len, "int32")]}


@pytest.mark.parametrize("blank", [0, 4])
def test_warpctc_lengths_values_and_grads(blank):
    rs = np.random.RandomState(8 + blank)
    # label lengths [0, 1, L, 3 - 1]; logit lengths 1 (a single frame),
    # 2, T and 3
    ins = _ctc_ins(rs, [0, 1, 3, 2], [1, 2, 6, 3], blank=blank)
    ins["Label"][0][2] = [1, 1, 3] if blank else [2, 2, 3]  # a repeat
    attrs = {"blank": blank, "norm_by_times": False}
    j = _jax("warpctc", ins, attrs)
    t = _port("warpctc", ins, attrs)
    np.testing.assert_allclose(t["Loss"][0].numpy(),
                               np.asarray(j["Loss"][0]), **SCAN)
    # norm_by_times leaves the loss as it is, as in the JAX package
    np.testing.assert_array_equal(
        _port("warpctc", ins, dict(attrs, norm_by_times=True))["Loss"][0]
        .numpy(), t["Loss"][0].numpy())
    g = rs.randn(4, 1).astype("float32")
    _, vjp = jax.vjp(lambda lg: jax_op("warpctc").lowering(
        JaxContext(None, None), dict(
            {k: [jnp.asarray(v[0])] for k, v in ins.items()},
            Logits=[lg]), attrs)["Loss"][0], jnp.asarray(ins["Logits"][0]))
    got = _port_grad("warpctc", ins, {"Loss": [t["Loss"][0].numpy()]},
                     {"Loss@GRAD": [g]}, attrs, [("Logits", 0)])
    dl = got["Logits@GRAD"][0].numpy()
    np.testing.assert_allclose(dl, np.asarray(vjp(jnp.asarray(g))[0]),
                               **SCAN)
    # frames past a row's logit length take no grad
    assert not dl[0, 1:].any() and not dl[3, 3:].any()


def test_warpctc_is_the_negative_log_of_the_summed_alignments():
    """exp(-Loss) against the sum over every frame labelling that
    collapses (repeats merged, blanks dropped) to the label (brute force,
    float64)."""
    rs = np.random.RandomState(9)
    T, C = 4, 3
    ins = _ctc_ins(rs, [0, 1, 2, 2], [4, 3, 4, 2], T=T, C=C, L=2)
    ins["Label"][0][3] = [1, 1]
    loss = _port("warpctc", ins, {"blank": 0})["Loss"][0].numpy()[:, 0]
    logits = ins["Logits"][0].astype(np.float64)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    for b in range(4):
        n, want = ins["LogitsLength"][0][b], \
            list(ins["Label"][0][b, :ins["LabelLength"][0][b]])
        total = 0.0
        for path in itertools.product(range(C), repeat=n):
            merged = [k for i, k in enumerate(path)
                      if i == 0 or k != path[i - 1]]
            if [k for k in merged if k != 0] == want:
                total += np.exp(sum(logp[b, t, k]
                                    for t, k in enumerate(path)))
        if total == 0.0:
            # no alignment fits (a repeat needs a blank between, and row
            # 3 has 2 frames for [1, 1]): the log-space floor, -NEG, as
            # in the JAX package
            assert loss[b] >= 1e29, (b, loss[b])
        else:
            np.testing.assert_allclose(loss[b], -np.log(total), atol=1e-4)


# ------------------------------------------------------- edit distance
def _levenshtein(a, b):
    d = np.arange(len(b) + 1)
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return d[-1]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_against_the_jax_package_and_levenshtein(normalized):
    rs = np.random.RandomState(10)
    hyp = rs.randint(0, 3, (6, 5)).astype("int32")
    ref = rs.randint(0, 3, (6, 7)).astype("int32")
    hl = np.array([5, 0, 3, 1, 5, 0], "int32")
    rl = np.array([7, 2, 0, 4, 1, 0], "int32")
    ins = {"Hyps": [hyp], "Refs": [ref], "HypsLength": [hl],
           "RefsLength": [rl]}
    attrs = {"normalized": normalized}
    j = _jax("edit_distance", ins, attrs)
    t = _port("edit_distance", ins, attrs)
    np.testing.assert_array_equal(t["Out"][0].numpy(),
                                  np.asarray(j["Out"][0]))
    np.testing.assert_array_equal(t["SequenceNum"][0].numpy(),
                                  np.asarray(j["SequenceNum"][0]))
    want = np.array([_levenshtein(hyp[b, :hl[b]], ref[b, :rl[b]])
                     for b in range(6)], "float32")
    if normalized:
        want = want / np.maximum(rl, 1).astype("float32")
    np.testing.assert_array_equal(t["Out"][0].numpy()[:, 0], want)


# -------------------------------------------------- hierarchical sigmoid
def test_hierarchical_sigmoid_walks_the_default_tree():
    """Class c's path: code = c + C, node (code >> (d + 1)) - 1 with bit
    (code >> d) & 1 while the node exists, the reference's SimpleCode;
    against the JAX package and a direct sum."""
    rs = np.random.RandomState(11)
    C, D = 6, 4
    x = rs.randn(6, D).astype("float32")
    w = rs.randn(C - 1, D).astype("float32")
    bias = rs.randn(C - 1).astype("float32")
    label = np.arange(C, dtype="int32")[:, None]
    ins = {"X": [x], "W": [w], "Bias": [bias], "Label": [label]}
    t = _port("hierarchical_sigmoid", ins, {"num_classes": C})["Out"][0]
    j = _jax("hierarchical_sigmoid", ins, {"num_classes": C})["Out"][0]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    for c in range(C):
        code, want = c + C, 0.0
        for d in range(8):
            node = (code >> (d + 1)) - 1
            if node < 0:
                break
            logit = x[c] @ w[node] + bias[node]
            want += np.log1p(np.exp(logit)) - ((code >> d) & 1) * logit
        np.testing.assert_allclose(t.numpy()[c, 0], want, atol=1e-5)


# --------------------------------------------------------- the RNG ops
def _startup_values(initializer, seed):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [64])
        pt.layers.fc(x, 256, param_attr=pt.ParamAttr(
            name="w", initializer=initializer))
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return scope.find_var("w").numpy().copy()


def test_truncated_normal_startup_is_seeded_and_truncated():
    init = pt.initializer.TruncatedNormal(loc=0.1, scale=0.5)
    a = _startup_values(init, 3)
    np.testing.assert_array_equal(_startup_values(init, 3), a)
    assert not np.array_equal(_startup_values(init, 4), a)
    assert a.min() >= 0.1 - 1.0 and a.max() <= 0.1 + 1.0
    # 16384 draws of N(0, 1) truncated to [-2, 2] (std 0.8796): within 5
    # standard errors
    assert abs(a.mean() - 0.1) < 5 * 0.5 * 0.8796 / 128
    assert abs(a.std() - 0.5 * 0.8796) < 5 * 0.5 / np.sqrt(2 * 16384)
    fixed = pt.initializer.TruncatedNormal(loc=0.1, scale=0.5, seed=17)
    np.testing.assert_array_equal(_startup_values(fixed, 3),
                                  _startup_values(fixed, 4))


def test_sampling_id_and_uniform_batch_size_like_in_a_program():
    def run(seed, sampling_seed=0):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = seed
        with pt.program_guard(main, startup):
            p = pt.layers.data("p", [4])
            ids = pt.layers.sampling_id(p, seed=sampling_seed)
            u = pt.layers.uniform_random_batch_size_like(
                p, [-1, 3], min=2.0, max=3.0)
        exe = pt.Executor(pt.CPUPlace())
        probs = np.tile(np.array([[0.0, 0.5, 0.0, 0.5]], "float32"),
                        (500, 1))
        return exe.run(main, feed={"p": probs}, fetch_list=[ids, u],
                       scope=pt.Scope())

    ids, u = run(1)
    assert set(np.unique(ids)) == {1, 3} and u.shape == (500, 3)
    assert u.min() >= 2.0 and u.max() < 3.0
    for a, b in zip(run(1), (ids, u)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(run(2)[0], ids)
    np.testing.assert_array_equal(run(1, 5)[0], run(2, 5)[0])


# ------------------------------------------------------- scatter's rule
def test_scatter_overwrite_keeps_the_last_of_repeated_ids():
    """The reference's CPU scatter loop: the last write of an id wins
    (JAX leaves it unspecified); every run the same."""
    x = np.zeros((5, 2), "float32")
    ids = np.array([3, 1, 3, 3, 1, 7], "int32")  # 7 is dropped
    upd = np.arange(12, dtype="float32").reshape(6, 2)
    ins = {"X": [x], "Ids": [ids], "Updates": [upd]}
    out = _port("scatter", ins, {"overwrite": True})["Out"][0].numpy()
    want = x.copy()
    for i, r in zip(ids, upd):
        if i < 5:
            want[i] = r
    np.testing.assert_array_equal(out, want)
    add = _port("scatter", ins, {"overwrite": False})["Out"][0].numpy()
    np.testing.assert_array_equal(add[3], upd[0] + upd[2] + upd[3])
    np.testing.assert_array_equal(add[1], upd[1] + upd[4])


# ------------------------------------------------------ layers at run time
def _run_layers(build, feed):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        fetch = build(pt.layers)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_the_layers_that_raised_run_on_the_cpu():
    """The six layers that raised KeyError for want of a lowering, a
    conv2d with groups equal to its channels (depthwise_conv2d), a
    TruncatedNormal startup and linspace's [1] bounds."""
    x = np.random.RandomState(12).randn(2, 4, 6, 6).astype("float32")
    lab = np.random.RandomState(13).rand(2, 4, 6, 6).astype("float32")

    def build(L):
        xv = L.data("x", [4, 6, 6])
        y = L.data("y", [4, 6, 6])
        parts = L.split(xv, 2, dim=1)
        return [parts[0], parts[1], L.square_error_cost(xv, y),
                L.sigmoid_cross_entropy_with_logits(xv, y),
                L.argmax(xv, axis=1), L.flatten(xv, axis=2),
                L.prelu(xv, "channel"),
                L.conv2d(xv, num_filters=4, filter_size=3, groups=4,
                         param_attr=pt.ParamAttr(
                             initializer=pt.initializer.TruncatedNormal(
                                 scale=0.1))),
                L.linspace(0.0, 1.0, 5)]

    out = _run_layers(build, {"x": x, "y": lab})
    np.testing.assert_array_equal(out[0], x[:, :2])
    np.testing.assert_allclose(out[2], (x - lab) ** 2, atol=1e-6)
    np.testing.assert_array_equal(out[4], x.argmax(1))
    assert out[5].shape == (8, 36) and out[7].shape == (2, 4, 4, 4)
    np.testing.assert_allclose(out[8], np.linspace(0, 1, 5), atol=1e-7)


def test_every_loss_layer_runs_against_the_jax_package():
    """Each function of the copied layers/loss.py builds and runs in both
    packages on one scope's weights."""
    from torch_parity import assert_runs_close, run_both

    rs = np.random.RandomState(14)
    feed = {"x": rs.randn(4, 6).astype("float32"),
            "y": rs.randn(4, 6).astype("float32"),
            "lab": np.array([[1], [0], [5], [2]], "int64"),
            "pm": np.array([[1.0], [-1.0], [1.0], [-1.0]], "float32"),
            "img": rs.randn(2, 3, 4, 5).astype("float32"),
            "seq": rs.randn(4, 5, 6).astype("float32"),
            "tags": rs.randint(0, 6, (4, 5)).astype("int64"),
            "ids": rs.randint(1, 6, (4, 3)).astype("int64"),
            "slen": np.array([5, 1, 3, 4], "int64"),
            "llen": np.array([0, 1, 3, 2], "int64")}

    def build(pkg):
        L = pkg.layers
        x, y = L.data("x", [6]), L.data("y", [6])
        lab, pm = L.data("lab", [1], dtype="int64"), L.data("pm", [1])
        img = L.data("img", [3, 4, 5])
        seq = L.data("seq", [5, 6])
        tags = L.data("tags", [5], dtype="int64")
        ids = L.data("ids", [3], dtype="int64")
        slen = L.data("slen", [], dtype="int64")
        llen = L.data("llen", [], dtype="int64")
        left = L.reduce_sum(x, dim=[1], keep_dim=True)
        right = L.reduce_sum(y, dim=[1], keep_dim=True)
        crf_attr = pkg.ParamAttr(name="crf_t")
        dist, _ = L.edit_distance(ids, ids, llen, llen)
        scale = L.create_parameter([3], "float32", name="ac_s")
        bias = L.create_parameter([3], "float32", name="ac_b")
        return [L.rank_loss(pm, left, right),
                L.margin_rank_loss(pm, left, right, margin=0.2),
                L.bpr_loss(x, lab), L.hsigmoid(x, lab, num_classes=6),
                L.warpctc(seq, ids, slen, llen),
                L.linear_chain_crf(seq, tags, length=slen,
                                   param_attr=crf_attr),
                L.crf_decoding(seq, param_attr=crf_attr, length=slen),
                dist,
                L.resize_bilinear(img, out_shape=[6, 3]),
                L.resize_nearest(img, out_shape=[7, 9]),
                L.image_resize(img, scale=2.0),
                L.affine_channel(img, scale=scale, bias=bias)]

    jres, tres, _, _ = run_both(build, [feed])
    assert_runs_close(jres, tres, **SCAN)

    # nce draws its negatives: its cost is finite and positive in the port
    def build_nce(L):
        return [L.nce(L.data("x", [6]), L.data("lab", [1], dtype="int64"),
                      num_total_classes=6, num_neg_samples=3)]

    (cost,) = _run_layers(build_nce, {"x": feed["x"], "lab": feed["lab"]})
    assert cost.shape == (4, 1) and (cost > 0).all()


def test_im2sequence_raises_as_in_the_jax_package():
    x = np.zeros((1, 1, 4, 4), "float32")
    for pkg in (jf, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            out = pkg.layers.im2sequence(pkg.layers.data("x", [1, 4, 4]),
                                         filter_size=2)
        exe = pkg.Executor(pkg.CPUPlace())
        with pytest.raises(Exception, match="im2sequence is not supported"):
            exe.run(main, feed={"x": x}, fetch_list=[out],
                    scope=pkg.Scope())
