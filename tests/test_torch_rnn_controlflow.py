"""The recurrent ops and control flow in the port against the JAX package
on the CPU: ``lstm`` / ``gru`` (``is_reverse``, ``origin_mode``,
``Length``), ``lstmp``, ``gru_unit``, ``lstm_unit``, ``recurrent``
through StaticRNN and DynamicRNN, ``While``, ``cond``, ``Switch``,
``IfElse``, ``scan_layers`` (``remat`` too), ``py_func``, the Print and
is_empty layers and ``beam_search``'s ties, on the programs of the JAX
package's tests (test_rnn_controlflow.py, test_rnn_blocks.py,
test_scan_layers.py, test_decode_misc.py), built by each package's
layer API and run on the JAX startup's weights
(``convert.params_from_jax``).

Tolerances: exact for control flow over exact arithmetic and for beam
ids and parents; atol 1e-5 for the recurrent loops' forward (f32
products summed in another order at every step) and 1e-5 plus rtol 1e-6
for their training steps' losses and grads; losses after Adam steps to
a relative 1e-5 (tests/test_torch_training.py's tolerance). Random ops
draw from another generator in each package, so the dropout cases hold
the port to itself: the grad's masks are the forward's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.lowering import release_schedule
from torch_parity import assert_runs_close, run_both

CPU = torch.device("cpu")


def _arr(rs, shape):
    return rs.randn(*shape).astype("float32")


# ------------------------------------------------------------ lstm / gru
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("origin", [False, True])
def test_dynamic_lstm_and_gru_match(reverse, origin):
    B, S, D = 4, 6, 8

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [S, 4 * D])
        g = L.data("g", [S, 3 * D])
        ln = L.data("len", [], dtype="int64")
        h, c = L.dynamic_lstm(x, size=4 * D, seq_len=ln, is_reverse=reverse)
        hg = L.dynamic_gru(g, size=D, seq_len=ln, is_reverse=reverse,
                           origin_mode=origin)
        hu = L.dynamic_gru(g, size=D, is_reverse=reverse,
                           origin_mode=origin)
        return [h, c, hg, hu]

    rs = np.random.RandomState(0)
    feeds = [{"x": _arr(rs, (B, S, 4 * D)), "g": _arr(rs, (B, S, 3 * D)),
              "len": np.array(lens, "int64")}
             for lens in ([1, 6, 3, 5], [6, 6, 6, 6])]
    jres, tres, _, _ = run_both(build, feeds)
    assert_runs_close(jres, tres, 1e-5)
    if not reverse:
        # padded steps emit zeros (a reverse walk masks by its own step
        # index, as the JAX package's scan does)
        assert np.all(tres[0][0][0, 1:] == 0)
        assert np.all(tres[0][2][2, 3:] == 0)


def test_lstmp_gru_unit_and_lstm_unit_layers_match():
    B, S, D, P = 3, 5, 6, 4

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [S, 4 * D])
        ln = L.data("len", [], dtype="int64")
        xg = L.data("xg", [3 * D])
        h0 = L.data("h0", [D])
        c0 = L.data("c0", [D])
        proj, cell = L.dynamic_lstmp(x, size=4 * D, proj_size=P)
        nh, rh, gate = L.gru_unit(xg, h0, size=3 * D)
        nho, _, _ = L.gru_unit(xg, h0, size=3 * D, origin_mode=True)
        uh, uc = L.lstm_unit(L.fc(h0, size=D), h0, c0, forget_bias=1.0)
        del ln
        return [proj, cell, nh, rh, gate, nho, uh, uc]

    rs = np.random.RandomState(1)
    feed = {"x": _arr(rs, (B, S, 4 * D)), "len": np.array([5, 1, 3]),
            "xg": _arr(rs, (B, 3 * D)), "h0": _arr(rs, (B, D)),
            "c0": _arr(rs, (B, D))}
    jres, tres, _, _ = run_both(build, [feed])
    assert_runs_close(jres, tres, 1e-5)


def test_lstm_gru_classifier_trains_like_the_jax_package():
    """test_rnn_controlflow.py's lstm + gru classifier, 3 Adam steps."""
    B, S, D = 4, 6, 8

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [S, 16])
        label = L.data("label", [1], dtype="int64")
        ln = L.data("len", [], dtype="int64")
        proj = L.fc(x, 4 * D, num_flatten_dims=2, bias_attr=False)
        h, _ = L.dynamic_lstm(proj, size=4 * D, seq_len=ln)
        proj2 = L.fc(h, 3 * D, num_flatten_dims=2, bias_attr=False)
        g = L.dynamic_gru(proj2, size=D, seq_len=ln, is_reverse=True)
        probs = L.fc(L.sequence_pool(g, "max", length=ln), 4, act="softmax")
        loss = L.mean(L.cross_entropy(probs, label))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss]

    rs = np.random.RandomState(0)
    feed = {"x": _arr(rs, (B, S, 16)),
            "label": rs.randint(0, 4, (B, 1)).astype("int64"),
            "len": np.array([1, 6, 3, 4], "int64")}
    jres, tres, _, _ = run_both(build, [feed] * 3)
    assert_runs_close(jres, tres, 0, rtol=1e-5)
    assert tres[2][0] < tres[0][0]


# ------------------------------------------------------------ control flow
def test_while_over_a_data_dependent_count():
    def build(pkg):
        L = pkg.layers
        n = L.data("n", [1], append_batch_size=False)
        x = L.data("x", [3], append_batch_size=False)
        i = L.fill_constant([1], "float32", 0.0)
        acc = L.fill_constant([3], "float32", 0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(acc, L.scale(x, 0.5)), output=acc)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), output=cond)
        return [acc, i]

    rs = np.random.RandomState(2)
    x = np.round(_arr(rs, (3,)) * 4) / 4
    feeds = [{"n": np.array([v], "float32"), "x": x} for v in (0, 1, 5, 12)]
    jres, tres, _, _ = run_both(build, feeds)
    assert_runs_close(jres, tres, 0)
    assert tres[2][1][0] == 5 and np.all(tres[2][0] == 2.5 * x)


def test_cond_switch_and_ifelse_match():
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [1], append_batch_size=False)
        out = L.fill_constant([1], "float32", 0.0)
        pred = L.greater_than(x, L.fill_constant([1], "float32", 0.5))
        L.cond(pred,
               true_fn=lambda: L.assign(L.scale(x, 2.0), output=out),
               false_fn=lambda: L.assign(L.scale(x, -1.0), output=out))
        sw_out = L.fill_constant([1], "float32", -7.0)
        sw = L.Switch()
        with sw.case(L.less_than(x, L.fill_constant([1], "float32", 0.0))):
            L.assign(L.fill_constant([1], "float32", 1.0), output=sw_out)
        with sw.case(L.less_than(x, L.fill_constant([1], "float32", 0.7))):
            L.assign(L.fill_constant([1], "float32", 2.0), output=sw_out)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 3.0), output=sw_out)
        return [out, sw_out]

    feeds = [{"x": np.array([v], "float32")} for v in (-0.4, 0.1, 0.6, 0.9)]
    jres, tres, _, _ = run_both(build, feeds)
    assert_runs_close(jres, tres, 0)
    assert [float(r[1][0]) for r in tres] == [1.0, 2.0, 2.0, 3.0]


def test_ifelse_merges_and_trains_like_the_jax_package():
    B, D = 16, 8

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [D])
        lab = L.data("lab", [1], dtype="int64")
        cond = L.less_than(lab, L.fill_constant([1], "int64", 1))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.fc(ie.input(x), size=4, act="tanh",
                           param_attr=pkg.ParamAttr(name="w_true")))
        with ie.false_block():
            ie.output(L.fc(ie.input(x), size=4, act="tanh",
                           param_attr=pkg.ParamAttr(name="w_false")))
        merged, = ie()
        loss = L.mean(L.square(merged))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [merged, loss]

    rs = np.random.RandomState(2)
    feed = {"x": _arr(rs, (B, D)),
            "lab": (rs.rand(B, 1) < 0.5).astype("int64")}
    jres, tres, _, tscope = run_both(build, [feed] * 3)
    assert_runs_close(jres, tres, 1e-6, rtol=1e-5)


def test_a_var_read_only_inside_a_while_body_lives_until_the_loop():
    """The release schedule counts a control-flow op's sub-block reads
    (``op_effects``): ``k`` is read by the loop body alone, after the
    last top-level op that names it, and must not leave the env before
    the ``while`` runs."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        k = L.fill_constant([1], "float32", 3.0)
        i = L.fill_constant([1], "float32", 0.0)
        s = L.fill_constant([1], "float32", 0.0)
        n = L.fill_constant([1], "float32", 4.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(s, k), output=s)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), output=cond)
    ops = main.global_block().ops
    release = release_schedule(ops, {s.name})
    at = {n_: j for j, names in enumerate(release) for n_ in names}
    loop = [j for j, op in enumerate(ops) if op.type == "while"][0]
    assert at[k.name] == loop and at[n.name] == loop
    (sv,) = pt.Executor(pt.CPUPlace()).run(main, fetch_list=[s],
                                           scope=pt.Scope())
    assert float(sv[0]) == 12.0


def test_conditional_block_refuses_in_place_ops_and_branch_shapes():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        x = L.data("x", [1], append_batch_size=False)
        out = L.fill_constant([1], "float32", 0.0)
        pred = L.greater_than(x, L.fill_constant([1], "float32", 0.5))
        L.cond(pred, true_fn=lambda: L.assign(
            L.fill_constant([2], "float32", 1.0), output=out))
    with pytest.raises(Exception, match="one shape and dtype"):
        pt.Executor(pt.CPUPlace()).run(
            main, feed={"x": np.array([1.0], "float32")}, fetch_list=[out],
            scope=pt.Scope())


# ------------------------------------------------------- StaticRNN & co
def test_static_rnn_matches_numpy_and_the_jax_package():
    T, B, D = 5, 3, 4

    def build(pkg):
        L = pkg.layers
        x3 = L.data("x3", [T, B, D], append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x3)
            prev = rnn.memory(shape=[-1, D], batch_ref=word,
                              ref_batch_dim_idx=1)
            new = L.elementwise_add(L.scale(prev, scale=0.5), word)
            rnn.update_memory(prev, new)
            rnn.step_output(new)
        return [rnn()]

    xs = _arr(np.random.RandomState(3), (T, B, D))
    jres, tres, _, _ = run_both(build, [{"x3": xs}])
    assert_runs_close(jres, tres, 1e-6)
    mem, want = np.zeros((B, D), "float32"), []
    for t in range(T):
        mem = mem * 0.5 + xs[t]
        want.append(mem)
    np.testing.assert_allclose(tres[0][0], np.stack(want), atol=1e-6)


def test_dynamic_rnn_masked_semantics_match():
    B, T, D = 4, 6, 3

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [B, T, D], append_batch_size=False)
        length = L.data("len", [B], dtype="int64", append_batch_size=False)
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x, length=length)
            prev = drnn.memory(shape=[D], value=0.0, dtype="float32")
            new = L.elementwise_add(prev, word)
            drnn.update_memory(prev, new)
            drnn.output(new)
        return [drnn()]

    rs = np.random.RandomState(1)
    feed = {"x": _arr(rs, (B, T, D)), "len": np.array([6, 3, 1, 4])}
    jres, tres, _, _ = run_both(build, [feed])
    assert_runs_close(jres, tres, 1e-6)
    assert np.all(tres[0][0][2, 1:] == 0)


def test_static_and_dynamic_rnn_mt_trains_like_the_jax_package():
    """test_rnn_blocks.py's book MT: a DynamicRNN encoder and a StaticRNN
    decoder, 3 Adam steps."""
    B, Ts, Tt, V, E, H = 8, 7, 5, 40, 16, 24

    def build(pkg):
        L = pkg.layers
        src = L.data("src", [B, Ts], dtype="int64", append_batch_size=False)
        src_len = L.data("src_len", [B], dtype="int64",
                         append_batch_size=False)
        trg = L.data("trg", [B, Tt], dtype="int64", append_batch_size=False)
        emb = L.embedding(src, size=[V, E])
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(emb, length=src_len)
            prev = drnn.memory(shape=[H], value=0.0, dtype="float32")
            hidden = L.fc([word, prev], size=H, act="tanh")
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        context = L.sequence_last_step(drnn(), src_len)
        trg_tm = L.transpose(L.embedding(trg, size=[V, E]), perm=[1, 0, 2])
        dec = L.StaticRNN()
        with dec.step():
            w = dec.step_input(trg_tm)
            st = dec.memory(init=context)
            new_st = L.fc([w, st], size=H, act="tanh")
            dec.update_memory(st, new_st)
            dec.step_output(new_st)
        logits = L.fc(dec(), size=V, num_flatten_dims=2)
        lbl = L.reshape(L.transpose(trg, perm=[1, 0]), shape=[Tt * B, 1])
        loss = L.mean(L.softmax_with_cross_entropy(
            L.reshape(logits, shape=[Tt * B, V]), lbl))
        pkg.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        return [loss]

    rs = np.random.RandomState(3)
    feed = {"src": rs.randint(1, V, (B, Ts)).astype("int64"),
            "src_len": np.array([1, 7, 3, 5, 2, 7, 6, 4], "int64"),
            "trg": rs.randint(1, V, (B, Tt)).astype("int64")}
    jres, tres, _, _ = run_both(build, [feed] * 3)
    assert_runs_close(jres, tres, 0, rtol=1e-5)


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_rnn_dropout_grad_replays_the_forward_masks(kind):
    """loss = sum over steps of dropout(x_t @ W) with W [1, 1]: dloss/dW
    = sum(mask * x_t) / (1 - p), so W * grad == loss exactly when the
    grad's re-run draws the forward's masks. A second run draws other
    masks (the chain moves on)."""
    T, B = 6, 8

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        L = pt.layers
        if kind == "static":
            x = L.data("x", [T, B, 1], append_batch_size=False)
            rnn = L.StaticRNN()
            with rnn.step():
                word = rnn.step_input(x)
                prev = rnn.memory(shape=[-1, 1], batch_ref=word,
                                  ref_batch_dim_idx=1)
                h = L.dropout(L.fc(word, size=1, bias_attr=False,
                                   param_attr=pt.ParamAttr(name="w")),
                              dropout_prob=0.5,
                              dropout_implementation="upscale_in_train")
                rnn.update_memory(prev, h)
                rnn.step_output(h)
        else:
            x = L.data("x", [B, T, 1], append_batch_size=False)
            ln = L.data("ln", [B], dtype="int64", append_batch_size=False)
            rnn = L.DynamicRNN()
            with rnn.block():
                word = rnn.step_input(x, length=ln)
                prev = rnn.memory(shape=[1], value=0.0, dtype="float32")
                h = L.dropout(L.fc(word, size=1, bias_attr=False,
                                   param_attr=pt.ParamAttr(name="w")),
                              dropout_prob=0.5,
                              dropout_implementation="upscale_in_train")
                rnn.update_memory(prev, h)
                rnn.output(h)
        loss = L.reduce_sum(rnn())
        pt.core.backward.append_backward(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    feed = {"x": np.abs(_arr(rs, tuple(v for v in x.shape)))}
    if kind == "dynamic":
        feed["ln"] = np.array([6, 1, 3, 6, 2, 5, 6, 4], "int64")
    w = float(np.asarray(scope.find_var("w")).reshape(()))
    l1, g1 = exe.run(main, feed=feed, fetch_list=[loss, "w@GRAD"],
                     scope=scope)
    np.testing.assert_allclose(w * float(g1.reshape(())),
                               float(l1.reshape(())), rtol=1e-5)
    l2, g2 = exe.run(main, feed=feed, fetch_list=[loss, "w@GRAD"],
                     scope=scope)
    np.testing.assert_allclose(w * float(g2.reshape(())),
                               float(l2.reshape(())), rtol=1e-5)
    assert float(l1.reshape(())) != float(l2.reshape(()))


# ------------------------------------------------------------ scan_layers
@pytest.mark.parametrize("remat", [False, True])
def test_scan_layers_trains_like_the_jax_package(remat):
    n, width = 3, 8

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [width])
        lbl = L.data("lbl", [1])
        cap = L.scale(x, scale=0.5)
        y = L.scan_layers(x, n, lambda h: L.elementwise_add(
            L.fc(h, size=width, act="tanh"), cap), remat=remat)
        loss = L.reduce_mean(L.square(L.elementwise_sub(L.fc(y, size=1),
                                                        lbl)))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss]

    rs = np.random.RandomState(0)
    feed = {"x": rs.rand(16, width).astype("float32"),
            "lbl": rs.rand(16, 1).astype("float32")}
    jres, tres, _, _ = run_both(build, [feed] * 3)
    assert_runs_close(jres, tres, 0, rtol=1e-5)


def test_scan_layers_dropout_grad_replays_each_layer():
    """A stochastic body trains (the grad replays each layer's recorded
    streams; a generic vjp would refuse randomness), remat or not, and
    the plain and remat programs give one loss on one seed."""
    losses = {}
    for remat in (False, True):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 9
        with pt.program_guard(main, startup), pt.unique_name.guard():
            L = pt.layers
            x = L.data("x", [4])
            y = L.scan_layers(x, 3, lambda h: L.dropout(
                L.fc(h, size=4, act="tanh"), dropout_prob=0.5), remat=remat)
            loss = L.reduce_mean(L.square(y))
            pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        X = np.random.RandomState(5).rand(8, 4).astype("float32")
        losses[remat] = [float(exe.run(main, feed={"x": X},
                                       fetch_list=[loss], scope=scope)[0])
                         for _ in range(3)]
        assert np.isfinite(losses[remat]).all()
    assert losses[False] == losses[True]


# ------------------------------------------------ py_func, Print, is_empty
def test_py_func_print_and_is_empty_layers(capsys):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [3])
        out = pkg.default_main_program().global_block().create_var(
            name="pyout", shape=(2, 3), dtype="float32")
        L.py_func(lambda a: a * 2 + 1, x, out)
        shown = L.Print(out, message="pyout")
        return [out, shown, L.is_empty(x)]

    X = np.arange(6, dtype=np.float32).reshape(2, 3)
    jres, tres, _, _ = run_both(build, [{"x": X}])
    assert_runs_close(jres, tres, 0)
    np.testing.assert_array_equal(tres[0][0], X * 2 + 1)
    assert "pyout" in capsys.readouterr().out


# ------------------------------------------------------------ beam search
def test_beam_search_ties_and_backtrack_match_the_jax_package():
    """Dead beams at NEG and a uniform first step tie every candidate:
    the parents and ids are the JAX package's (lowest flat index first),
    and the backtrack through two steps agrees."""
    B, K, V = 3, 4, 6

    def build(pkg):
        L = pkg.layers
        pre_ids = L.data("pre_ids", [K], dtype="int64")
        pre_sc = L.data("pre_sc", [K], dtype="float32")
        s1 = L.data("s1", [K, V], dtype="float32")
        s2 = L.data("s2", [K, V], dtype="float32")
        ids1, sc1, par1 = L.beam_search(pre_ids, pre_sc, s1, beam_size=K,
                                        end_id=0)
        ids2, sc2, par2 = L.beam_search(ids1, sc1, s2, beam_size=K,
                                        end_id=0)
        sent, final = L.beam_search_decode(
            L.stack([ids1, ids2], axis=0), L.stack([sc1, sc2], axis=0),
            L.stack([par1, par2], axis=0), beam_size=K, end_id=0)
        return [ids1, sc1, par1, ids2, sc2, par2, sent, final]

    rs = np.random.RandomState(4)
    uniform = np.log(np.full((B, K, V), 1.0 / V, "float32"))
    dead = np.array([[0.0] + [-1e9] * (K - 1)] * B, "float32")
    feeds = [{"pre_ids": np.ones((B, K), "int64"), "pre_sc": dead,
              "s1": uniform, "s2": uniform},
             {"pre_ids": np.array([[1, 0, 2, 0]] * B, "int64"),
              "pre_sc": np.zeros((B, K), "float32"), "s1": uniform,
              "s2": np.log(rs.dirichlet(np.ones(V), (B, K)))
              .astype("float32")}]
    jres, tres, _, _ = run_both(build, feeds)
    assert_runs_close(jres, tres, 0)
    # a uniform step from one live beam: parent 0, ids 0..K-1 in order
    np.testing.assert_array_equal(tres[0][2], np.zeros((B, K)))
    np.testing.assert_array_equal(tres[0][0], np.tile(np.arange(K), (B, 1)))
