"""Program parity between the JAX package and the port on the CPU.

``run_both(build, feeds)`` builds one Program with each package's layer
API (``build(pkg) -> list of fetch Variables``, under a fresh
``program_guard`` and ``unique_name.guard``, so both programs name their
vars alike), runs the JAX package's startup, moves its persistables
into a port scope with ``convert.params_from_jax``, runs both programs
on the same numpy feeds, and returns both packages' fetches per run.
"""

import numpy as np
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import params_from_jax

CPU = torch.device("cpu")


def build_both(build, seed=5):
    """{"jax": (main, startup, fetches), "port": (...)}."""
    out = {}
    for key, pkg in (("jax", jf), ("port", pt)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetches = build(pkg)
        out[key] = (main, startup, list(fetches))
    return out


def jax_state(main, scope):
    """The JAX scope's persistables of ``main``, as numpy by name."""
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def port_scope(state, main):
    """A port scope holding ``state`` (``params_from_jax``)."""
    scope = pt.Scope()
    for n, t in params_from_jax(state, main, CPU).items():
        scope.set_var(n, t)
    return scope


def run_both(build, feeds, seed=5, programs=None):
    """Both packages' fetches for each feed dict of ``feeds``, run in
    turn on one scope each: ([jax fetches per run], [port fetches per
    run], jax scope, port scope)."""
    programs = programs or build_both(build, seed)
    jmain, jstart, jfetch = programs["jax"]
    tmain, _, tfetch = programs["port"]
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    tscope = port_scope(jax_state(jmain, jscope), tmain)
    texe = pt.Executor(pt.CPUPlace())
    jres, tres = [], []
    for feed in feeds:
        jres.append([np.asarray(v) for v in jexe.run(
            jmain, feed=feed, fetch_list=[v.name for v in jfetch],
            scope=jscope)])
        tres.append([np.asarray(v) for v in texe.run(
            tmain, feed=feed, fetch_list=[v.name for v in tfetch],
            scope=tscope)])
    return jres, tres, jscope, tscope


def assert_runs_close(jres, tres, atol, rtol=0.0, exact_ints=True):
    """Every fetch of every run: float within (atol, rtol), integer and
    bool exactly."""
    for step, (js, ts) in enumerate(zip(jres, tres)):
        for i, (a, b) in enumerate(zip(js, ts)):
            assert a.shape == b.shape, (step, i, a.shape, b.shape)
            if exact_ints and a.dtype.kind in "iub":
                np.testing.assert_array_equal(
                    b.astype(a.dtype), a, err_msg="run %d fetch %d"
                    % (step, i))
            else:
                np.testing.assert_allclose(
                    b.astype(np.float64), a.astype(np.float64), atol=atol,
                    rtol=rtol, err_msg="run %d fetch %d" % (step, i))
