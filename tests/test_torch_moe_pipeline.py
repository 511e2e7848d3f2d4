"""The port's ``moe_ffn`` and ``pipeline`` ops, their layers
(layers/parallel_ext.py, a copy) and their per-position algorithms
(parallel/moe.py, parallel/pipeline.py) against the JAX package on the
CPU; and gradient accumulation, which the pipeline tests compose with.

Routing is compared bitwise (expert index, slot position, keep mask);
gates and aux losses within 1e-6. Programs start from the JAX package's
post-startup scope (``convert.params_from_jax``) and run the same numpy
feeds: losses within a relative 1e-5, params within atol 1e-4
(tests/test_torch_training.py's tolerances). The port's engine runs on
8 ``CPUPlace()`` positions; the JAX package's single-device run is the
reference its own engine matches on those meshes
(tests/test_moe_engine.py, tests/test_pipeline_engine.py). Properties
the JAX package pins within itself (expert path against the local path,
pipe mesh against the sequential fallback with dropout on) are pinned
within the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.parallel.moe import moe_apply as jax_moe_apply
from paddle_tpu.parallel.moe import route_tokens as jax_route
from paddle_tpu_torch.parallel import moe_apply, pipeline_apply
from paddle_tpu_torch.parallel.engine import ParallelEngine, make_mesh
from paddle_tpu_torch.parallel.mesh import P
from paddle_tpu_torch.parallel.moe import route_tokens

from torch_parity import jax_state, port_scope

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
D, E, H = 16, 8, 32
CPU8 = [pt.CPUPlace()] * 8


@pytest.fixture(scope="module", autouse=True)
def _no_global_gradient_clip():
    """tests/test_grad_accum.py leaves the JAX package's process-global
    gradient clip set; this module runs with neither package's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.clip, "_global_clip", None)
        mp.setattr(pt.clip, "_global_clip", None)
        yield


def _first(v):
    return float(np.asarray(v).reshape(-1)[0])


def _pair(build, seed=5):
    progs = {}
    for key, pkg in (("jax", jf), ("port", pt)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            progs[key] = (main, startup, build(pkg))
    jmain, jstart, _ = progs["jax"]
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(jstart, scope=jscope)
    state = jax_state(jmain, jscope)
    return progs, jscope, state


def _params(main, state):
    return sorted(v.name for v in main.list_vars()
                  if v.persistable and v.name in state)


def _jax_losses(progs, jscope, feed, steps):
    jmain, _, jf_ = progs["jax"]
    fetch = jf_ if isinstance(jf_, (list, tuple)) else [jf_]
    exe = jf.Executor(jf.CPUPlace())
    return [_first(exe.run(jmain, feed=feed, fetch_list=[fetch[0]],
                           scope=jscope)[0]) for _ in range(steps)]


# ------------------------------------------------------------------- moe
@pytest.mark.parametrize("top_k,capacity,z_loss", [
    (1, 64, 0.0), (2, 64, 0.0), (3, 16, 0.0), (1, 3, 1e-2), (2, 5, 0.0)])
def test_route_tokens_is_the_jax_packages(top_k, capacity, z_loss):
    """Top-k routing and choice-major capacity claims: expert index, slot
    position and keep mask bitwise; gates and aux (with z-loss) within
    1e-6; small capacities drop tokens alike."""
    rs = np.random.RandomState(top_k)
    x = rs.randn(40, D).astype("float32")
    g = rs.randn(D, E).astype("float32")
    want = jax_route(jnp.asarray(x), jnp.asarray(g), E, capacity, top_k,
                     z_loss)
    got = route_tokens(torch.tensor(x), torch.tensor(g), E, capacity, top_k,
                       z_loss)
    for i in (0, 2, 3):  # expert_idx, pos, keep
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(want[i]).astype(
                                          got[i].numpy().dtype))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_allclose(float(got[4]), float(want[4]), atol=1e-6)
    if capacity < 8:
        assert not got[3].all()  # some tokens overflowed


def test_moe_apply_matches_the_jax_packages_all_to_all():
    """``moe_apply`` over 8 positions (all_to_all out to the experts and
    back, top-2, z-loss) against the JAX package's under ``shard_map``
    on its 8 devices: outputs and aux losses within 1e-5."""
    rs = np.random.RandomState(0)
    w1 = rs.randn(E, D, H).astype("float32") * 0.3
    b1 = rs.randn(E, H).astype("float32") * 0.1
    w2 = rs.randn(E, H, D).astype("float32") * 0.3
    b2 = rs.randn(E, D).astype("float32") * 0.1
    g = rs.randn(D, E).astype("float32")
    x = rs.randn(E * 8, D).astype("float32")
    mesh = JaxMesh(np.array(jax.devices()), ("expert",))
    fn = jax.shard_map(
        lambda a, b, c, d, gg, xx: (lambda o, aux: (o, aux[None]))(
            *jax_moe_apply((a, b, c, d), gg, xx, "expert", capacity=4,
                           top_k=2, z_loss=1e-2)),
        mesh=mesh, in_specs=(JP("expert"),) * 4 + (JP(), JP("expert")),
        out_specs=(JP("expert"), JP("expert")), check_vma=False)
    out, aux = jax.jit(fn)(*map(jnp.asarray, (w1, b1, w2, b2, g, x)))
    outs, auxes = moe_apply(tuple(map(torch.tensor, (w1, b1, w2, b2))),
                            torch.tensor(g),
                            list(torch.tensor(x).chunk(E)), capacity=4,
                            top_k=2, z_loss=1e-2)
    np.testing.assert_allclose(torch.cat(outs).numpy(), np.asarray(out),
                               atol=1e-5)
    np.testing.assert_allclose([float(a) for a in auxes],
                               np.asarray(aux).reshape(-1), atol=1e-6)


def every_expert(x, w1, b1, w2, b2, gate_w, E, capacity, top_k, z_loss):
    """The JAX package's single-device ``moe_ffn`` formula
    (paddle_tpu/ops/moe_ops.py ``_moe_local``) in torch: every expert on
    every token, outputs selected by routing."""
    expert_idx, gate, _pos, keep, aux = route_tokens(x, gate_w, E, capacity,
                                                     top_k, z_loss)
    out = torch.zeros_like(x)
    for e in range(E):
        y = torch.relu(x @ w1[e] + b1[e]) @ w2[e] + b2[e]
        for kk in range(top_k):
            sel = ((expert_idx[kk] == e) & keep[kk])[:, None]
            out = out + torch.where(sel, y * gate[kk][:, None], 0.0)
    return out, aux


@pytest.mark.parametrize("top_k,capacity", [(1, 64), (2, 5), (3, 16)])
def test_moe_lowering_matches_the_every_expert_formula(top_k, capacity):
    """The port's one ``moe_ffn`` lowering (each expert on its capacity
    rows) against the every-expert formula, the JAX package's own and
    its torch copy: outputs within 1e-5 (the two sum in other orders),
    aux within 1e-6, and every input's grad (of a random cotangent on
    both outputs) within 1e-5 of the copy's (the op's grad against the
    JAX package's is tests/test_torch_training.py's case), capacity
    drops included."""
    from paddle_tpu.ops.moe_ops import _moe_local as jax_every_expert
    from paddle_tpu_torch.ops.moe_ops import _moe

    rs = np.random.RandomState(top_k)
    arrays = [rs.randn(40, D), rs.randn(E, D, H) * 0.3, rs.randn(E, H) * 0.1,
              rs.randn(E, H, D) * 0.3, rs.randn(E, D) * 0.1, rs.randn(D, E)]
    arrays = [a.astype("float32") for a in arrays]
    g_out = rs.randn(40, D).astype("float32")
    args = (E, capacity, top_k, 1e-2)

    def grads(fn):
        leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
        out, aux = fn(*leaves, *args)
        got = torch.autograd.grad(
            (out * torch.tensor(g_out)).sum() + 0.5 * aux, leaves)
        return out.detach(), aux.detach(), got

    out, aux, got = grads(lambda *a: _moe(*a, None))
    ref_out, ref_aux, ref = grads(every_expert)
    jout, jaux = jax_every_expert(*map(jnp.asarray, arrays), *args)
    assert capacity > 16 or not route_tokens(
        torch.tensor(arrays[0]), torch.tensor(arrays[5]), E, capacity,
        top_k)[3].all()
    for want_out, want_aux in ((ref_out, ref_aux), (jout, jaux)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2", "gate"), got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=name)


def _moe_model(capacity=None, top_k=1):
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[D], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h, aux = pkg.layers.moe_ffn(x, n_experts=E, d_hidden=H,
                                    capacity=capacity, top_k=top_k,
                                    z_loss=1e-3)
        pred = pkg.layers.fc(h, size=1)
        mse = pkg.layers.mean(pkg.layers.square(pred - y))
        loss = pkg.layers.elementwise_add(
            mse, pkg.layers.scale(aux, scale=0.01))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss, aux, h]

    return build


def _moe_feed(batch=32, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(batch, D).astype("float32"),
            "y": rs.rand(batch, 1).astype("float32")}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_trains_like_the_jax_package(top_k):
    """``layers.moe_ffn`` through 4 Adam steps: the port's run on an
    (expert 8) mesh against the JAX package's run (top-1; top-2's
    routing and all_to_all are held above), and within the port the
    (expert 8) run against the no-mesh run (outputs within 1e-6); the
    stacked expert params take P('expert')."""
    progs, jscope, state = _pair(_moe_model(top_k=top_k))
    tmain, _, (tl, taux, th) = progs["port"]
    feed = _moe_feed()
    jls = _jax_losses(progs, jscope, feed, 4) if top_k == 1 else None
    tscope, lscope = port_scope(state, tmain), port_scope(state, tmain)
    eng = ParallelEngine(tmain, tl.name, mesh=make_mesh(CPU8, ("expert",)))
    local = pt.Executor(pt.CPUPlace())
    tls, lls = [], []
    for _ in range(4):
        l, a, h = eng.run(feed, [tl, taux, th], tscope)
        l2, a2, h2 = local.run(tmain, feed=feed, fetch_list=[tl, taux, th],
                               scope=lscope)
        np.testing.assert_allclose(h, h2, atol=1e-6)
        assert abs(_first(a) - _first(a2)) <= 1e-6
        tls.append(_first(l))
        lls.append(_first(l2))
    np.testing.assert_allclose(tls, lls, rtol=1e-6)
    if jls is not None:
        np.testing.assert_allclose(tls, jls, rtol=LOSS_RTOL)
        for n in _params(tmain, state):
            np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                       np.asarray(jscope.find_var(n)),
                                       atol=PARAM_ATOL, err_msg=n)
    specs = next(iter(eng._cache.values())).state_specs
    assert all(specs[n] == P("expert") for n in tmain._expert_params)
    assert "all_gather axis=expert positions=8" in eng.lowered_collectives(
        feed, [tl], tscope)


def test_moe_ffn_drops_overflow_and_refuses_a_wrong_axis():
    """capacity=1 on identical tokens keeps only the first (Switch
    overflow discipline) on both paths; E != the expert axis' size
    raises as the JAX package does."""
    progs, _, state = _pair(_moe_model(capacity=1))
    tmain, _, (tl, _, th) = progs["port"]
    x = np.tile(np.linspace(0.1, 0.9, D).astype("float32"), (6, 1))
    feed = {"x": x, "y": np.zeros((6, 1), "float32")}
    main_test = tmain.clone(for_test=True)
    for mesh in (None, make_mesh(CPU8, ("expert",))):
        scope = port_scope(state, tmain)
        if mesh is None:
            (out,) = pt.Executor(pt.CPUPlace()).run(
                main_test, feed=feed, fetch_list=[th.name], scope=scope)
        else:
            eng = ParallelEngine(main_test, mesh=mesh)
            (out,) = eng.run(feed, [th.name], scope)
        assert (np.abs(out).sum(axis=1) > 1e-9).sum() == 1
    eng = ParallelEngine(tmain, tl.name,
                         mesh=make_mesh(CPU8, ("expert", "data"), (4, 2)))
    with pytest.raises(Exception, match="one-per-device"):
        eng.run(_moe_feed(), [tl], port_scope(state, tmain))


# -------------------------------------------------------------- pipeline
def test_pipeline_apply_matches_sequential_with_grads():
    """``pipeline_apply``'s schedule over 4 positions (8 microbatches)
    against the stages applied in turn: outputs bitwise, grads within
    1e-6."""
    rs = np.random.RandomState(0)
    Ws = torch.tensor(rs.randn(4, D, D).astype("float32") * 0.3,
                      requires_grad=True)
    x = torch.tensor(rs.randn(8, 2, D).astype("float32"))
    stage = lambda w, h: torch.tanh(h @ w)  # noqa: E731
    out = pipeline_apply(stage, list(Ws), x)
    (gp,) = torch.autograd.grad(out.sum(), Ws)
    ref = x
    for s in range(4):
        ref = stage(Ws[s], ref)
    (gs,) = torch.autograd.grad(ref.sum(), Ws)
    assert torch.equal(out, ref)
    # the grads sum over microbatches in another order: rounding apart
    torch.testing.assert_close(gp, gs, rtol=0, atol=1e-6)


def _stage(pkg, dropout):
    def stage(pb, xin):
        w = pb.param([D, D])
        b = pb.param([D], is_bias=True)
        h = pkg.layers.relu(pkg.layers.elementwise_add(
            pkg.layers.matmul(xin, w), b))
        return pkg.layers.dropout(h, dropout_prob=0.3) if dropout else h
    return stage


def _pipe_model(n_stages=4, n_mb=None, dropout=False, opt="sgd"):
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[D], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.pipeline(x, n_stages=n_stages,
                                stage_fn=_stage(pkg, dropout),
                                n_microbatches=n_mb)
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        if opt == "sgd":
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        else:
            pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return loss

    return build


def _pipe_feed(batch=16):
    rs = np.random.RandomState(0)
    return {"x": rs.rand(batch, D).astype("float32"),
            "y": rs.rand(batch, 1).astype("float32")}


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "accum2"])
def test_pipeline_trains_like_the_jax_package(accum):
    """``layers.pipeline`` (4 stages) through 4 SGD steps on a (pipe 4)
    and a (data 2, pipe 4) mesh and on the sequential fallback, against
    the JAX package's run; with gradient accumulation over 2 slices on
    both packages. The stacked params take P('pipe')."""
    progs, jscope, state = _pair(_pipe_model())
    jmain = progs["jax"][0]
    tmain, _, tl = progs["port"]
    if accum > 1:
        jmain.set_gradient_accumulation(accum)
        tmain.set_gradient_accumulation(accum)
    feed = _pipe_feed()
    jls = _jax_losses(progs, jscope, feed, 4)
    meshes = [None, make_mesh(CPU8[:4], ("pipe",)),
              make_mesh(CPU8, ("data", "pipe"), (2, 4))]
    for mesh in meshes:
        scope = port_scope(state, tmain)
        if mesh is None:
            exe = pt.Executor(pt.CPUPlace())
            run = lambda: exe.run(tmain, feed=feed,  # noqa: E731
                                  fetch_list=[tl], scope=scope)[0]
        else:
            eng = ParallelEngine(tmain, tl.name, mesh=mesh)
            run = lambda: eng.run(feed, [tl], scope)[0]  # noqa: E731
        tls = [_first(run()) for _ in range(4)]
        np.testing.assert_allclose(tls, jls, rtol=LOSS_RTOL, err_msg=mesh)
        for n in _params(tmain, state):
            np.testing.assert_allclose(scope.find_var(n).numpy(),
                                       np.asarray(jscope.find_var(n)),
                                       atol=PARAM_ATOL, err_msg=n)
        if mesh is not None:
            specs = next(iter(eng._cache.values())).state_specs
            assert all(specs[n] == P("pipe")
                       for n in tmain._pipeline_params)
            txt = eng.lowered_collectives(feed, [tl], scope)
            assert "ppermute axis=pipe positions=4" in txt
            assert ("data_positions=2" in txt) == ("data" in mesh.shape)


def test_pipeline_dropout_masks_follow_stage_and_microbatch():
    """With dropout in the stages, the (pipe 4) and (data 2, pipe 4)
    meshes train bitwise the sequential fallback (each (stage,
    microbatch) draws from a chain folded from the op's one stream); the
    masks change from step to step."""
    progs, _, state = _pair(_pipe_model(dropout=True, opt="adam"))
    tmain, _, tl = progs["port"]
    feed = _pipe_feed()
    runs = []
    for mesh in (None, make_mesh(CPU8[:4], ("pipe",)),
                 make_mesh(CPU8, ("data", "pipe"), (2, 4))):
        scope = port_scope(state, tmain)
        if mesh is None:
            exe = pt.Executor(pt.CPUPlace())
            run = lambda: exe.run(tmain, feed=feed,  # noqa: E731
                                  fetch_list=[tl], scope=scope)[0]
        else:
            eng = ParallelEngine(tmain, tl.name, mesh=mesh)
            run = lambda: eng.run(feed, [tl], scope)[0]  # noqa: E731
        runs.append([_first(run()) for _ in range(4)])
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][0] > runs[0][-1]
    test_prog = tmain.clone(for_test=True)
    scope = port_scope(state, tmain)
    exe = pt.Executor(pt.CPUPlace())
    main_fwd = tmain.clone()
    a, b = (_first(exe.run(main_fwd, feed=feed, fetch_list=[tl],
                           scope=scope)[0]) for _ in range(2))
    assert a != b
    c, d = (_first(exe.run(test_prog, feed=feed, fetch_list=[tl.name],
                           scope=port_scope(state, tmain))[0])
            for _ in range(2))
    assert c == d


def test_pipeline_shape_refusals():
    """The GPipe shape contract, the stage count against the pipe axis
    and the batch against the microbatches are refused as the JAX
    package refuses them."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[D], dtype="float32")

        def bad_stage(pb, xin):
            return pt.layers.matmul(xin, pb.param([D, D * 2]))

        with pytest.raises(ValueError, match="GPipe"):
            pt.layers.pipeline(x, n_stages=2, stage_fn=bad_stage)
    for n_stages, n_mb, batch, match in ((2, None, 16, "one-per-device"),
                                         (4, 3, 16, "divisible")):
        progs, _, state = _pair(_pipe_model(n_stages, n_mb))
        tmain, _, tl = progs["port"]
        eng = ParallelEngine(tmain, tl.name,
                             mesh=make_mesh(CPU8, ("data", "pipe"), (2, 4)))
        with pytest.raises(Exception, match=match):
            eng.run(_pipe_feed(batch), [tl], port_scope(state, tmain))


def test_gradient_accumulation_matches_the_jax_package():
    """``Program.set_gradient_accumulation(2)`` on a sum loss (not
    microbatch-mean invariant: the averaged slice grads are half the
    full batch's): 3 SGD steps agree with the JAX package's; a batch the
    slices do not divide is refused."""
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[D], dtype="float32")
        loss = pkg.layers.reduce_sum(pkg.layers.fc(x, size=4, act="tanh"))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return loss

    progs, jscope, state = _pair(build)
    jmain, tmain = progs["jax"][0], progs["port"][0]
    tl = progs["port"][2]
    jmain.set_gradient_accumulation(2)
    tmain.set_gradient_accumulation(2)
    feed = {"x": np.random.RandomState(1).rand(8, D).astype("float32")}
    jls = _jax_losses(progs, jscope, feed, 3)
    scope = port_scope(state, tmain)
    exe = pt.Executor(pt.CPUPlace())
    tls = [_first(exe.run(tmain, feed=feed, fetch_list=[tl],
                          scope=scope)[0]) for _ in range(3)]
    np.testing.assert_allclose(tls, jls, rtol=LOSS_RTOL)
    for n in _params(tmain, state):
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   atol=PARAM_ATOL, err_msg=n)
    with pytest.raises(Exception, match="not divisible by gradient"):
        exe.run(tmain, feed={"x": feed["x"][:7]}, fetch_list=[tl],
                scope=scope)
