"""Recompute (core/recompute.py, a copy; ops/recompute_ops.py, a port;
``optimizer.RecomputeOptimizer``) in the port, on the CPU: the port's
counterparts of the JAX package's tests/test_recompute.py, and the port
against the JAX package.

- Within the port: an MLP's recompute program's losses, grads and
  params are bitwise those of the plain program, with dropout in a
  segment too (the grad's re-run takes the forward's streams); the
  dropout mask the grad replays is the forward's; a BERT with dropout
  agrees with its plain program (bitwise first loss, then within the
  parity tolerances); the error cases.
- Against the JAX package: the MLP and the 2-layer BERT with a
  checkpoint per encoder layer (dropout off), built by both packages
  into the same Program, 3 Adam steps from one transplanted scope:
  losses to a relative 1e-5 and params to atol 1e-4
  (tests/test_torch_training.py's tolerances), and one step's param
  grads to atol 1e-5 plus a relative 1e-4.
- C5: ``RecomputeOptimizer.minimize`` imported a ``core/recompute.py``
  the port lacked (``ModuleNotFoundError``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.backward import calc_gradient
from paddle_tpu_torch.core.recompute import apply_recompute
from paddle_tpu_torch.models import bert as tbert

CPU = torch.device("cpu")


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


def _build_mlp(pkg, use_dropout=False):
    L = pkg.layers
    x = L.data("x", [16])
    y = L.data("y", [1])
    h1 = L.fc(x, size=32, act="relu")
    if use_dropout:
        h1 = L.dropout(h1, dropout_prob=0.3)
    h2 = L.fc(h1, size=32, act="tanh")
    h3 = L.fc(h2, size=16, act="relu")
    pred = L.fc(h3, size=1)
    loss = L.mean(L.square(L.elementwise_sub(pred, y)))
    return (h1, h2, h3), loss


def _program(pkg, recompute, use_dropout=False, opt="SGD", lr=0.1, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        (h1, h2, _), loss = _build_mlp(pkg, use_dropout)
        inner = getattr(pkg.optimizer, opt)(learning_rate=lr)
        if recompute:
            o = pkg.optimizer.RecomputeOptimizer(inner)
            o._set_checkpoints([h1, h2])
            _, pgs = o.minimize(loss)
        else:
            _, pgs = inner.minimize(loss)
    return main, startup, loss, pgs


def _feed(seed=0, n=8):
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(n, 16).astype("float32"),
            "y": rs.rand(n, 1).astype("float32")}


def _train(recompute, steps=5, use_dropout=False):
    main, startup, loss, _ = _program(pt, recompute, use_dropout)
    if recompute:
        kinds = [op.type for op in main.global_block().ops]
        assert kinds.count("recompute_block") == 2
        assert kinds.count("recompute_block_grad") == 2
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _feed()
    return [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
            .tobytes() for _ in range(steps)]


def test_recompute_optimizer_minimize_runs():
    """C5: minimize imported the missing core/recompute.py."""
    main, _, _, pgs = _program(pt, True)
    assert pgs and "recompute_block" in [
        op.type for op in main.global_block().ops]


@pytest.mark.parametrize("use_dropout", [False, True])
def test_recompute_matches_plain_bitwise(use_dropout):
    assert _train(True, use_dropout=use_dropout) == \
        _train(False, use_dropout=use_dropout)


def test_recompute_grads_match_plain_grads():
    def grads(recompute):
        main, startup, _, pgs = _program(pt, recompute, lr=0.0, seed=0)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        return exe.run(main, feed=_feed(1, 4),
                       fetch_list=[g.name for _, g in pgs], scope=scope)

    gp, gr = grads(False), grads(True)
    assert len(gp) == len(gr) == 8
    for a, b in zip(gp, gr):
        assert a.tobytes() == b.tobytes()


def test_recompute_dropout_grad_replays_forward_mask():
    """The grad re-runs the segment with the forward's dropout stream:
    the mask is recovered from the segment's output, so a fresh stream
    in the grad gives a gradient that provably mismatches."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 123
    p = 0.5
    with pt.program_guard(main, startup):
        x = pt.layers.create_parameter(
            [4, 8], "float32", attr=pt.ParamAttr(
                initializer=pt.initializer.UniformInitializer(
                    low=0.5, high=1.5, seed=9)))
        d = pt.layers.dropout(x, dropout_prob=p,
                              dropout_implementation="upscale_in_train")
        s = pt.layers.scale(d, scale=2.0)  # segment = [dropout, scale]
        loss = pt.layers.mean(pt.layers.square(s))
        apply_recompute(main, [s])
        assert "recompute_block" in [op.type for op in
                                     main.global_block().ops]
        (gx,) = calc_gradient(loss, [x])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    xv, sv, gv = exe.run(main, feed={}, fetch_list=[x, s, gx], scope=scope)
    n = sv.size
    mask_scaled = (sv / 2.0) / xv
    expected = 2.0 * sv * 2.0 * mask_scaled / n
    assert np.any(sv == 0) and np.any(sv != 0), "want a non-trivial mask"
    np.testing.assert_allclose(gv, expected, rtol=1e-5, atol=1e-6)


def test_recompute_after_backward_raises():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        (h1, _, _), loss = _build_mlp(pt)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
        with pytest.raises(RuntimeError, match="before append_backward"):
            apply_recompute(main, [h1])


def test_recompute_unknown_checkpoint_raises():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        _build_mlp(pt)
        with pytest.raises(ValueError, match="not produced"):
            apply_recompute(main, ["no_such_var"])


def test_recompute_optimizer_needs_checkpoints():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        _, loss = _build_mlp(pt)
        with pytest.raises(RuntimeError, match="_set_checkpoints"):
            pt.optimizer.RecomputeOptimizer(
                pt.optimizer.SGD(learning_rate=0.1)).minimize(loss)


def test_fetching_segment_internal_var_errors_clearly():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [8])
        h1 = pt.layers.fc(x, size=8, act="relu")  # internal to the segment
        h2 = pt.layers.scale(h1, scale=2.0)       # the checkpoint
        loss = pt.layers.mean(h2)
        apply_recompute(main, [h2])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.zeros((2, 8), "float32")}
    exe.run(main, feed=feed, fetch_list=[loss, h2], scope=scope)
    with pytest.raises(Exception, match="recompute"):
        exe.run(main, feed=feed, fetch_list=[h1], scope=scope)


def test_recompute_program_infer_clone_runs():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [16])
        h1 = pt.layers.fc(x, size=32, act="relu")
        h1 = pt.layers.dropout(h1, dropout_prob=0.4)
        h2 = pt.layers.fc(h1, size=16, act="tanh")
        pred = pt.layers.fc(h2, size=4, act="sigmoid")
        apply_recompute(main, [h2])
        infer = main.clone(for_test=True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).rand(8, 16).astype("float32")}
    (a,) = exe.run(infer, feed=feed, fetch_list=[pred], scope=scope)
    (b,) = exe.run(infer, feed=feed, fetch_list=[pred], scope=scope)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (8, 4) and ((a > 0) & (a < 1)).all()


def test_recompute_draws_as_many_streams_in_the_grad():
    """A grad re-run that draws past the forward's streams raises."""
    from paddle_tpu_torch.core.lowering import LowerContext

    ctx = LowerContext(None, torch.Generator(), CPU)
    ctx.replay = []
    with pytest.raises(RuntimeError, match="more random streams"):
        ctx.next_rng()
    ctx.replay = [5]
    a = ctx.next_rng()
    b = torch.Generator().manual_seed(5)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


# ------------------------------------------------- against the JAX package
def _transplant(state, main):
    scope = pt.Scope()
    for n, v in params_from_jax(state, main, CPU).items():
        scope.set_var(n, v)
    return scope


def _both(build, feeds, fetch_grads=False):
    """The JAX package's and the port's losses (and first step's param
    grads) over ``feeds`` and final params, the port from the JAX
    package's post-startup scope."""
    out = []
    for pkg in (jf, pt):
        main, startup, loss, pgs = build(pkg)
        assert "recompute_block" in [op.type for op in
                                     main.global_block().ops]
        if pkg is jf:
            exe, scope = jf.Executor(jf.CPUPlace()), jf.Scope()
            exe.run(startup, scope=scope)
            state = {v.name: np.array(scope.find_var(v.name))
                     for v in main.list_vars() if v.persistable}
        else:
            exe, scope = pt.Executor(pt.CPUPlace()), _transplant(state, main)
        grads = [g.name for _, g in pgs] if fetch_grads else []
        losses, first = [], None
        for i, f in enumerate(feeds):
            vals = exe.run(main, feed=f, fetch_list=[loss] + grads,
                           scope=scope)
            losses.append(float(np.asarray(vals[0]).reshape(-1)[0]))
            if i == 0:
                first = [np.asarray(v) for v in vals[1:]]
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.global_block().all_parameters()}
        out.append((losses, first, params))
    return out


def _check(jax_out, port_out):
    (jl, jg, jp), (tl, tg, tp) = jax_out, port_out
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
    for n, want in jp.items():
        np.testing.assert_allclose(tp[n], want, atol=1e-4, rtol=0,
                                   err_msg=n)


def test_mlp_recompute_matches_jax():
    jax_out, port_out = _both(
        lambda pkg: _program(pkg, True, opt="Adam", lr=1e-2),
        [_feed(i) for i in range(3)], fetch_grads=True)
    _check(jax_out, port_out)


BERT_CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
                type_vocab=2, max_length=40, dropout=0.0)
S, M, B = 40, 6, 3


def _bert(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    bert = jbert if pkg is jf else tbert
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ckpts = []
        loss, _ = bert.build(BERT_CFG, seq_len=S, max_mask=M,
                             checkpoints=ckpts)
        assert len(ckpts) == BERT_CFG["n_layer"]
        o = pkg.optimizer.RecomputeOptimizer(
            pkg.optimizer.Adam(learning_rate=1e-3))
        o._set_checkpoints(ckpts)
        _, pgs = o.minimize(loss)
    return main, startup, loss, pgs


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
            "src_ids": rs.randint(0, BERT_CFG["vocab"], (B, S)).astype(
                "int64"),
            "sent_ids": rs.randint(0, 2, (B, S)).astype("int64"),
            "input_mask": mask, "mask_pos": pos,
            "mask_label": rs.randint(0, BERT_CFG["vocab"], (B, M)).astype(
                "int64"),
            "mask_weight": weight})
    return out


def test_bert_recompute_matches_jax():
    jax_out, port_out = _both(_bert, _bert_feeds(3))
    _check(jax_out, port_out)


def test_bert_recompute_with_dropout_trains_like_plain():
    """Dropout 0.1 in every layer: the recompute program draws the plain
    program's masks (the first loss is bitwise the plain one's), and over
    3 steps its losses and params agree with the plain program's at
    test_torch_training.py's tolerances. Not bitwise: a segment's grads
    come from the vjp of its forward ops, where the plain program runs
    the custom grad lowerings (fused_attention's recomputes its forward),
    which round in another order."""
    cfg = dict(BERT_CFG, dropout=0.1)

    def run(recompute):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 11
        with pt.program_guard(main, startup), pt.unique_name.guard():
            ckpts = []
            loss, _ = tbert.build(cfg, seq_len=S, max_mask=M,
                                  checkpoints=ckpts)
            opt = pt.optimizer.Adam(learning_rate=1e-3)
            if recompute:
                opt = pt.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints(ckpts)
            opt.minimize(loss)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in _bert_feeds(3)]
        return losses, {p.name: scope.find_var(p.name).numpy()
                        for p in main.global_block().all_parameters()}

    (lr, pr), (lp, pp) = run(True), run(False)
    assert lr[0].tobytes() == lp[0].tobytes()
    np.testing.assert_allclose(lr, lp, rtol=1e-5, atol=0)
    for n, want in pp.items():
        np.testing.assert_allclose(pr[n], want, atol=1e-4, rtol=0,
                                   err_msg=n)
