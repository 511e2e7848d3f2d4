"""Checkpoints in the port (io.py): ``save_params`` / ``load_params``,
``vars=``, ``save_persistables_async`` and ``AsyncCheckpoint``.

- The six cases of tests/test_async_checkpoint.py against the port: the
  snapshot is the state at call time while training goes on, the async
  file equals a sync save's, a write error surfaces on ``wait()``, two
  async saves to one path serialize (the second is final), an
  uninitialized var raises in the caller, and a sync save drains an
  in-flight async one to the same path and leaves no staging file.
- Files cross packages both ways, bitwise: ``save_params`` and
  ``save_persistables`` from one package load with ``load_params`` /
  ``load_persistables`` / ``load_vars(vars=...)`` in the other.
- A run with dropout 0.1, checkpointed after step 3 with the RNG chain
  (``extra_vars=[core.executor.RNG_VAR]``) and resumed in a fresh scope and
  executor, takes steps 4-6 bitwise as the uninterrupted run: losses
  and every persistable.
- The documented exception: the RNG chain is a ``torch.Generator`` in
  the port and a threefry key in the JAX package; the port saves its
  state as uint8 and refuses the JAX package's key.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.core.executor import RNG_VAR as JAX_RNG_VAR
from paddle_tpu_torch import io
from paddle_tpu_torch.core.executor import RNG_VAR
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.native.tensor_store import load_tensors

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _no_global_gradient_clip():
    """tests/test_grad_accum.py leaves the JAX package's process-global
    gradient clip set; this module runs with neither package's set."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.clip, "_global_clip", None)
        mp.setattr(pt.clip, "_global_clip", None)
        yield


def _build(pkg=pt, dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        h = pkg.layers.fc(x, 16, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _feed(seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(16, 8).astype("float32"),
            "y": rs.randn(16, 1).astype("float32")}


def _persistables(main, scope):
    return {v.name: scope.find_var(v.name).numpy().copy()
            for v in main.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


def _trained(dropout=0.0):
    main, startup, loss = _build(dropout=dropout)
    scope, exe = Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    return main, startup, loss, scope, exe


# ------------------------------------------- tests/test_async_checkpoint.py
def test_async_save_snapshot_isolated_from_later_steps(tmp_path):
    main, startup, loss, scope, exe = _trained()
    snap = _persistables(main, scope)
    ckpt = io.save_persistables_async(exe, str(tmp_path / "ck"), main,
                                      scope=scope)
    for i in range(5):
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
    ckpt.wait()
    assert ckpt.done()
    scope2 = Scope()
    exe.run(startup, scope=scope2)
    io.load_persistables(exe, str(tmp_path / "ck"), main, scope=scope2)
    for n, v in snap.items():
        np.testing.assert_array_equal(scope2.find_var(n).numpy(), v,
                                      err_msg=n)


def test_async_save_matches_sync_save(tmp_path):
    main, _, _, scope, exe = _trained()
    io.save_persistables(exe, str(tmp_path / "sync"), main, scope=scope)
    io.save_persistables_async(exe, str(tmp_path / "async"), main,
                               scope=scope).wait()
    a = load_tensors(str(tmp_path / "sync" / "__model_combined__"))
    b = load_tensors(str(tmp_path / "async" / "__model_combined__"))
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    main, _, _, scope, exe = _trained()
    target = str(tmp_path / "ro")
    io.save_persistables_async(exe, target, main, scope=scope).wait()
    import paddle_tpu_torch.native.tensor_store as ts

    def boom(path, tensors):
        raise IOError("injected write failure")

    monkeypatch.setattr(ts, "save_tensors", boom)
    ckpt = io.save_persistables_async(exe, target, main, scope=scope)
    with pytest.raises(IOError, match="injected"):
        ckpt.wait()


def test_two_async_saves_same_path_serialize(tmp_path):
    main, _, loss, scope, exe = _trained()
    c1 = io.save_persistables_async(exe, str(tmp_path / "ck"), main,
                                    scope=scope)
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
    snap2 = _persistables(main, scope)
    c2 = io.save_persistables_async(exe, str(tmp_path / "ck"), main,
                                    scope=scope)
    c1.wait()
    c2.wait()
    final = load_tensors(str(tmp_path / "ck" / "__model_combined__"))
    for n, v in snap2.items():
        np.testing.assert_array_equal(final[n], v, err_msg=n)


def test_uninitialized_var_raises_immediately(tmp_path):
    main, startup, loss = _build()
    scope, exe = Scope(), pt.Executor(pt.CPUPlace())
    with pytest.raises(RuntimeError, match="not initialized"):
        io.save_persistables_async(exe, str(tmp_path / "ck"), main,
                                   scope=scope)


def test_sync_save_drains_inflight_async_to_same_path(tmp_path):
    main, _, loss, scope, exe = _trained()
    c1 = io.save_persistables_async(exe, str(tmp_path / "ck"), main,
                                    scope=scope)
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
    snap = _persistables(main, scope)
    io.save_persistables(exe, str(tmp_path / "ck"), main, scope=scope)
    c1.wait()
    final = load_tensors(str(tmp_path / "ck" / "__model_combined__"))
    for n, v in snap.items():
        np.testing.assert_array_equal(final[n], v, err_msg=n)
    leftover = [p for p in (tmp_path / "ck").iterdir() if ".tmp" in p.name]
    assert not leftover, leftover


# ------------------------------------------------------------ cross-package
def _jax_trained():
    main, startup, loss = _build(jf)
    scope, exe = jf.Scope(), jf.Executor(jf.CPUPlace())
    with jf.scope_guard(scope):
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    return main, scope, exe


def test_params_cross_packages_both_ways(tmp_path):
    jmain, jscope, jexe = _jax_trained()
    main, startup, _, scope, exe = _trained()
    params = sorted(p.name for p in main.global_block().all_parameters())
    assert params == sorted(p.name for p in
                            jmain.global_block().all_parameters())
    # JAX -> port: save_params, then load_params into a fresh port scope
    jf.io.save_params(jexe, str(tmp_path / "j"), jmain, scope=jscope)
    assert sorted(load_tensors(str(tmp_path / "j" /
                                   "__model_combined__"))) == params
    fresh = Scope()
    exe.run(startup, scope=fresh)
    io.load_params(exe, str(tmp_path / "j"), main, scope=fresh)
    for n in params:
        np.testing.assert_array_equal(fresh.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    # port -> JAX
    io.save_params(exe, str(tmp_path / "t"), main, scope=scope)
    jfresh = jf.Scope()
    jf.io.load_params(jexe, str(tmp_path / "t"), jmain, scope=jfresh)
    for n in params:
        np.testing.assert_array_equal(np.asarray(jfresh.find_var(n)),
                                      scope.find_var(n).numpy())
    # persistables (moments, beta powers, the learning rate) too
    io.save_persistables(exe, str(tmp_path / "tp"), main, scope=scope)
    jf.io.load_persistables(jexe, str(tmp_path / "tp"), jmain,
                            scope=jfresh)
    for n, v in _persistables(main, scope).items():
        np.testing.assert_array_equal(np.asarray(jfresh.find_var(n)), v,
                                      err_msg=n)


def test_vars_argument_both_ways(tmp_path):
    jmain, jscope, jexe = _jax_trained()
    main, startup, _, scope, exe = _trained()
    some = ["fc_0.w_0", "fc_1.b_0"]
    io.save_vars(exe, str(tmp_path / "t"), main, vars=some, scope=scope)
    assert sorted(load_tensors(str(tmp_path / "t" /
                                   "__model_combined__"))) == sorted(some)
    jf.io.save_vars(jexe, str(tmp_path / "j"), jmain,
                    vars=[jmain.global_block().var(n) for n in some],
                    scope=jscope)
    fresh = Scope()
    exe.run(startup, scope=fresh)
    untouched = fresh.find_var("fc_0.b_0").clone()
    io.load_vars(exe, str(tmp_path / "j"), main,
                 vars=[main.global_block().var(some[0]), some[1]],
                 scope=fresh)
    for n in some:
        np.testing.assert_array_equal(fresh.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    assert torch.equal(fresh.find_var("fc_0.b_0"), untouched)
    jfresh = jf.Scope()
    jf.io.load_vars(jexe, str(tmp_path / "t"), jmain, vars=some,
                    scope=jfresh)
    for n in some:
        np.testing.assert_array_equal(np.asarray(jfresh.find_var(n)),
                                      scope.find_var(n).numpy())
    with pytest.raises(RuntimeError, match="lacks variable"):
        io.load_vars(exe, str(tmp_path / "t"), main, vars=["fc_0.b_0"],
                     scope=fresh)


# ---------------------------------------------------------------- resuming
def test_resume_with_dropout_is_bitwise_the_uninterrupted_run(tmp_path):
    main, startup, loss = _build(dropout=0.1)
    feeds = [_feed(10 + i) for i in range(6)]
    exe = pt.Executor(pt.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    losses, ckpt = [], None
    for i, f in enumerate(feeds):
        losses.append(exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0])
        if i == 2:
            ckpt = io.save_persistables_async(
                exe, str(tmp_path / "ck"), main, scope=scope,
                extra_vars=[RNG_VAR, "no_such_var"])
    ckpt.wait()
    saved = load_tensors(str(tmp_path / "ck" / "__model_combined__"))
    assert saved[RNG_VAR].dtype == np.uint8 and "no_such_var" not in saved

    exe2, fresh = pt.Executor(pt.CPUPlace()), Scope()
    exe2.run(startup, scope=fresh)
    io.load_persistables(exe2, str(tmp_path / "ck"), main, scope=fresh)
    io.load_vars(exe2, str(tmp_path / "ck"), main, vars=[RNG_VAR],
                 scope=fresh)
    assert isinstance(fresh.find_var(RNG_VAR), torch.Generator)
    resumed = [exe2.run(main, feed=f, fetch_list=[loss], scope=fresh)[0]
               for f in feeds[3:]]
    np.testing.assert_array_equal(np.stack(resumed), np.stack(losses[3:]))
    for n, v in _persistables(main, scope).items():
        np.testing.assert_array_equal(fresh.find_var(n).numpy(), v,
                                      err_msg=n)
    # without the chain the masks differ: the chain is what resumes them
    exe3, bare = pt.Executor(pt.CPUPlace()), Scope()
    exe3.run(startup, scope=bare)
    io.load_persistables(exe3, str(tmp_path / "ck"), main, scope=bare)
    other = exe3.run(main, feed=feeds[3], fetch_list=[loss], scope=bare)[0]
    assert not np.array_equal(other, losses[3])


def test_rng_chain_is_the_documented_exception(tmp_path):
    """The JAX package's chain is a uint32 threefry key: the port refuses
    it by name. Every other var of the same file loads."""
    main, startup, loss = _build(jf, dropout=0.1)
    scope, exe = jf.Scope(), jf.Executor(jf.CPUPlace())
    with jf.scope_guard(scope):
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        jf.io.save_persistables_async(
            exe, str(tmp_path / "j"), main, scope=scope,
            extra_vars=[JAX_RNG_VAR]).wait()
    assert JAX_RNG_VAR == RNG_VAR
    tmain, tstart, _ = _build(pt, dropout=0.1)
    texe, tscope = pt.Executor(pt.CPUPlace()), Scope()
    texe.run(tstart, scope=tscope)
    io.load_persistables(texe, str(tmp_path / "j"), tmain, scope=tscope)
    with pytest.raises(RuntimeError, match="do not share"):
        io.load_vars(texe, str(tmp_path / "j"), tmain, vars=[RNG_VAR],
                     scope=tscope)
    # the port's chain saves as the generator's state
    io.save_vars(texe, str(tmp_path / "t"), tmain, vars=[RNG_VAR],
                 scope=tscope)
    state = load_tensors(str(tmp_path / "t" / "__model_combined__"))[RNG_VAR]
    np.testing.assert_array_equal(
        state, tscope.find_var(RNG_VAR).get_state().numpy())
