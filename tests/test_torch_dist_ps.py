"""Parameter-server training in the port on localhost.

In-process (pservers on threads, each binding port 0 through a prebound
``RPCServer``, so no test races for a port): the distributed sparse
table; DeepFM held to the JAX package's run of the same job from the
same post-startup state; a sliced dense param over two pservers, sync
against one process and async. Under ``slow``, as the JAX package's
tests/test_dist_ps.py marks them (each starts 2-4 Python processes
that import torch, and the fault cases wait out RPC deadlines): real
processes, this file run as the worker (``python
tests/test_torch_dist_ps.py`` with the PADDLE_* role env), the losses
held to one process's, a killed pserver's named error, and a restarted
pserver resuming from its checkpoint.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.distributed import ps as ps_runtime  # noqa: E402
from paddle_tpu_torch.distributed.rpc import RPCServer  # noqa: E402

# the small DeepFM of the JAX package's tests/dist_ctr_script.py
CTR_STEPS, VOCAB, N_FIELDS, N_DENSE, EMB, CTR_BATCH = 6, 64, 4, 3, 8, 16
# the linear regression of tests/dist_lr_script.py
LR_STEPS, LR, FEATURES = 5, 0.1, 6
# DeepFM in the port against the JAX package, both on the CPU from the
# same state: torch's and XLA's CPU kernels sum the fc products in
# different orders, so a loss moves by float32 rounding (read 1.6e-07
# relative over the 6 steps) and a param by a few ulps (read 3.0e-08
# absolute, the fm_v table); the bounds leave about 30x room
PARITY_LOSS_RTOL = 5e-6
PARITY_PARAM_ATOL = 1e-6


def _cpu():
    return fluid.Executor(fluid.CPUPlace())


# endpoint -> the prebound server serving it (its published store is
# what a trainer's recv reads)
SERVERS = {}


def _prebound(n, num_trainers=1, sync=True, runtime=ps_runtime,
              Server=RPCServer):
    """``n`` servers bound to port 0, registered for the pserver loop:
    their endpoints, comma-joined."""
    eps = []
    for _ in range(n):
        srv = Server(port=0, num_trainers=num_trainers, sync=sync)
        ep = "127.0.0.1:%d" % srv.port
        runtime.register_prebound_server(ep, srv)
        SERVERS[ep] = srv
        eps.append(ep)
    return ",".join(eps)


def _wait_published(srv, before, timeout=60):
    """Until every var of ``before`` ({name: value}) has a new value in
    ``srv``'s published store: an async pserver applies and publishes
    each grad on its own thread."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if all(not np.array_equal(srv.get_var(n), v)
               for n, v in before.items()):
            return
        time.sleep(0.01)
    raise AssertionError("the async pserver published nothing new")


def _serve(pkg, t, ep, exe, scope, before=None):
    """A daemon thread running ``ep``'s pserver startup, then
    ``before(scope)`` where given, then its loop."""
    def run():
        exe.run(t.get_startup_program(ep), scope=scope)
        if before is not None:
            before(scope)
        exe.run(t.get_pserver_program(ep), scope=scope)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _lr_build(pkg=fluid):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[FEATURES], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(
            x, size=1,
            param_attr=pkg.ParamAttr(
                name="fc_w", initializer=pkg.initializer.Constant(0.5)),
            bias_attr=pkg.ParamAttr(
                name="fc_b", initializer=pkg.initializer.Constant(0.0)))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(LR).minimize(loss)
    return main, startup, loss


def _lr_data(step):
    rng = np.random.RandomState(100 + step)
    X = rng.randn(32, FEATURES).astype(np.float32)
    W = np.linspace(-1, 1, FEATURES).astype(np.float32).reshape(-1, 1)
    return X, X @ W + 0.3


def _ctr_build(pkg=fluid, distributed=True):
    ctr = __import__(pkg.__name__ + ".models.ctr", fromlist=["ctr"])
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = ctr.build("deepfm", N_FIELDS, N_DENSE, VOCAB, emb_dim=EMB,
                         distributed=distributed)[0]
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _ctr_data(step):
    rs = np.random.RandomState(200 + step)
    ids = rs.randint(0, VOCAB, (CTR_BATCH, N_FIELDS)).astype("int64")
    dense = rs.rand(CTR_BATCH, N_DENSE).astype("float32")
    label = rs.randint(0, 2, (CTR_BATCH, 1)).astype("int64")
    return {"sparse_ids": ids, "dense": dense, "label": label}


def _single_losses(build, feeds):
    main, startup, loss = build()
    exe, scope = _cpu(), fluid.Scope()
    exe.run(startup, scope=scope)
    return [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
            for f in feeds]


# ------------------------------------------------------------ in process
def test_distributed_sparse_table_in_process():
    """Distributed lookup table: the trainer prefetches rows and ships
    SelectedRows grads; the pserver scatter-applies SGD. The pserver
    runs on a thread, the trainer in-process."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            ids, size=[20, 4], is_sparse=True, is_distributed=True,
            param_attr=fluid.ParamAttr(name="emb_w"))
        pred = fluid.layers.fc(emb, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.2).minimize(loss)

    eps = _prebound(1)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                sync_mode=True, startup_program=startup)
    tp = t.get_trainer_program()
    types = [op.type for op in tp.global_block().ops]
    assert "prefetch" in types and "send_sparse" in types
    assert "lookup_table" not in types and "lookup_table_grad" not in types
    specs = {s["param_block"]: s for s in
             t.get_pserver_program(eps).global_block().ops[0]
             .attrs["block_specs"]}
    assert specs["emb_w"].get("sparse") is True

    th = _serve(fluid, t, eps, _cpu(), fluid.Scope())
    scope, exe = fluid.Scope(), _cpu()
    exe.run(t.get_trainer_startup_program(), scope=scope)
    rng = np.random.RandomState(0)
    IDS = rng.randint(0, 20, (32, 1)).astype(np.int64)
    Y = IDS.astype(np.float32) / 10.0
    losses = []
    for _ in range(12):
        lv, = exe.run(tp, feed={"ids": IDS, "y": Y},
                      fetch_list=[loss.name], scope=scope)
        losses.append(float(lv))
    exe.close()
    th.join(timeout=60)
    assert not th.is_alive(), "the pserver loop did not end after close()"
    assert losses[-1] < losses[0] * 0.5, losses


def _trained_cluster(pkg, runtime, Server, jax_state=None):
    """DeepFM's 6 steps through ``pkg``: one trainer against two threaded
    pservers. The JAX package runs its transpiled startup; the port
    starts from ``jax_state`` (the JAX trainer's post-startup
    persistables): the dense params pushed by the trainer push program,
    the tables set on their pservers before they serve. Returns (losses,
    post-startup trainer state, every pserver's persistables by name)."""
    main, startup, loss = _ctr_build(pkg)
    cfg = pkg.DistributeTranspilerConfig()
    cfg.min_block_size = 64
    eps = _prebound(2, runtime=runtime, Server=Server)
    t = pkg.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                sync_mode=True, startup_program=startup)
    tp = t.get_trainer_program()
    port = pkg is fluid
    mk = _cpu if port else (lambda: pkg.Executor(pkg.CPUPlace()))
    tables = [i["var"].name for i in t.table_infos.values()]
    ps_scopes, threads = {}, []
    for ep in eps.split(","):
        ps_scopes[ep] = pkg.Scope()
        before = None
        if port:
            def before(scope, ep=ep):
                import torch

                for spec in scope_specs(t, ep):
                    if spec in tables:
                        scope.set_var(spec, torch.from_numpy(
                            np.array(jax_state[spec])))
        threads.append(_serve(pkg, t, ep, mk(), ps_scopes[ep], before))
    exe, scope = mk(), pkg.Scope()
    if port:
        from paddle_tpu_torch.convert import params_from_jax
        import torch

        for n, v in params_from_jax(jax_state, tp,
                                    torch.device("cpu")).items():
            scope.set_var(n, v)
        exe.run(t.get_trainer_push_program(), scope=scope)
        state = None
    else:
        exe.run(t.get_trainer_startup_program(), scope=scope)
        state = {v.name: np.array(np.asarray(scope.find_var(v.name)))
                 for v in tp.list_vars()
                 if v.persistable and scope.find_var(v.name) is not None}
    losses = [float(exe.run(tp, feed=_ctr_data(s), fetch_list=[loss],
                            scope=scope)[0]) for s in range(CTR_STEPS)]
    exe.close()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    params = {}
    for ep, sc in ps_scopes.items():
        for name in scope_specs(t, ep):
            v = sc.find_var(name)
            params[name] = (v.numpy() if port else np.asarray(v)).copy()
    return losses, state, params


def scope_specs(t, ep):
    """The param blocks and tables ``ep`` hosts."""
    op = t.get_pserver_program(ep).global_block().ops[0]
    return [s["param_block"] for s in op.attrs["block_specs"]]


def test_deepfm_tracks_the_jax_packages_run():
    """The small DeepFM of the JAX package's cluster test, one trainer
    against two pservers in both packages from the JAX package's
    post-startup state: every loss and every pserver param (the dense
    blocks and both sparse tables) within the stated bounds."""
    import paddle_tpu as jf
    from paddle_tpu.distributed import ps as jps
    from paddle_tpu.distributed.rpc import RPCServer as JServer

    jl, state, jparams = _trained_cluster(jf, jps, JServer)
    tl, _, tparams = _trained_cluster(fluid, ps_runtime, RPCServer, state)
    np.testing.assert_allclose(tl, jl, rtol=PARITY_LOSS_RTOL)
    assert sorted(tparams) == sorted(jparams)
    assert any(n.startswith("fm_") or "emb" in n for n in tparams)
    for n in jparams:
        np.testing.assert_allclose(tparams[n], jparams[n],
                                   atol=PARITY_PARAM_ATOL, err_msg=n)
    moved = [n for n in jparams if not np.array_equal(jparams[n],
                                                      state.get(n, 0))]
    assert len(moved) == len(jparams), "a param did not train"
    assert jl[-1] < jl[0]


def _lr_cluster(n_ps, sync, min_block_size):
    main, startup, loss = _lr_build()
    cfg = fluid.DistributeTranspilerConfig()
    cfg.min_block_size = min_block_size
    eps = _prebound(n_ps, sync=sync)
    t = fluid.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                sync_mode=sync, startup_program=startup)
    threads = [_serve(fluid, t, ep, _cpu(), fluid.Scope())
               for ep in eps.split(",")]
    exe, scope = _cpu(), fluid.Scope()
    exe.run(t.get_trainer_startup_program(), scope=scope)
    tp = t.get_trainer_program()
    losses = []
    for step in range(LR_STEPS):
        X, Y = _lr_data(step)
        srv = SERVERS[eps.split(",")[0]]
        before = {} if sync else {n: srv.get_var(n)
                                  for n in ("fc_w", "fc_b")}
        losses.append(float(exe.run(tp, feed={"x": X, "y": Y},
                                    fetch_list=[loss], scope=scope)[0]))
        if not sync:
            # the next step's recv must read this step's update
            _wait_published(srv, before)
    exe.close()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    return losses, t


def test_sync_sliced_param_over_two_pservers_matches_single_process():
    losses, t = _lr_cluster(2, True, 2)
    types = [op.type for op in t.get_trainer_program().global_block().ops]
    assert "split" in types and "concat" in types
    single = _single_losses(_lr_build, [
        dict(zip(("x", "y"), _lr_data(s))) for s in range(LR_STEPS)])
    np.testing.assert_allclose(losses, single, rtol=2e-4, atol=1e-5)


def test_async_ps_converges():
    losses, _ = _lr_cluster(1, False, 8192)
    assert min(losses[1:]) < losses[0], losses


# ------------------------------------- each op against the JAX lowering
# the six op types this file holds against the JAX package's lowerings
# (tests/test_torch_ops.py's registry census counts them here)
DIST_OPS = sorted(["send", "send_sparse", "send_barrier", "recv",
                   "fetch_barrier", "prefetch"])


def _lowered(pkg, op_type, ins, attrs):
    """Op ``op_type``'s lowering in ``pkg`` ("jax" or "port") called on
    numpy ``ins``: {slot: [numpy]}."""
    import torch

    if pkg == "jax":
        import jax.numpy as jnp
        from paddle_tpu.core.lowering import LowerContext as JaxContext
        from paddle_tpu.core.registry import get_op as jax_op

        out = jax_op(op_type).lowering(
            JaxContext(None, None),
            {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
            dict(attrs))
        return {k: [np.asarray(x) for x in v] for k, v in out.items()}
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    out = get_op(op_type).lowering(
        LowerContext(None, None, torch.device("cpu")),
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in ins.items()}, dict(attrs))
    return {k: [x.numpy() for x in v] for k, v in out.items()}


def _reset_pools():
    from paddle_tpu.ops.distributed_ops import reset_clients as jax_reset
    from paddle_tpu_torch.ops.distributed_ops import reset_clients

    jax_reset()
    reset_clients()


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, np.ascontiguousarray(a).tobytes()


def _both_against(op_type, ins, attrs, serve, sync=False):
    """Each package's lowering against a server of its own: ``serve(srv,
    run)`` sets the server up and calls ``run()`` (the lowering) at the
    point of the exchange, returning what the server saw. Returns
    {pkg: (outputs, what the server saw)}."""
    got = {}
    for pkg in ("jax", "port"):
        srv = RPCServer(port=0, num_trainers=1, sync=sync)
        srv.start()
        ep = "127.0.0.1:%d" % srv.port
        a = dict(attrs)
        for k in ("endpoint",):
            if k in a:
                a[k] = ep
        if "endpoints" in a:
            a["endpoints"] = [ep]
        outs = {}

        def run(pkg=pkg, a=a):
            outs.update(_lowered(pkg, op_type, ins, a))

        try:
            seen = serve(srv, run)
        finally:
            _reset_pools()
            srv.close()
        got[pkg] = (outs, seen)
    return got


def _flag_ok(outs):
    (flag,) = outs["Out"]
    assert flag.shape == () and flag.dtype == np.int32 and flag == 0


def _pop_all(srv, n):
    items = []
    for _ in range(n):
        item = srv.pop_async(timeout_ms=5000)
        assert item is not None
        items.append(item)
    return items


def _case_send(rs):
    x = rs.randn(3, 5).astype(np.float32)
    for name in ("w", "w@GRAD"):
        got = _both_against(
            "send", {"X": [x]}, {"endpoint": None, "var_name": name},
            lambda srv, run: (run(), _pop_all(srv, 1))[1])
        for pkg, (outs, seen) in got.items():
            _flag_ok(outs)
            ((n, v, tid),) = seen
            assert (n, tid) == (name, 0) and _bits(v) == _bits(x), pkg


def _case_send_sparse(rs):
    rows = np.array([3, 1, 3, 0, 5], np.int64)
    vals = rs.randn(5, 4).astype(np.float32)
    for pad in (-1, 3):
        got = _both_against(
            "send_sparse", {"Rows": [rows], "Values": [vals]},
            {"endpoint": None, "var_name": "t@GRAD", "height": 9,
             "padding_idx": pad},
            lambda srv, run: (run(), _pop_all(srv, 1))[1])
        want = vals if pad == -1 else np.where((rows == pad)[:, None], 0,
                                               vals)
        for pkg, (outs, seen) in got.items():
            _flag_ok(outs)
            ((n, sr, _),) = seen
            assert n == "t@GRAD" and sr.height == 9, pkg
            assert list(sr.rows) == list(rows), pkg
            assert _bits(sr.values) == _bits(want.astype(np.float32)), pkg


def _barrier_cycle(srv, run_send, run_fetch):
    """One sync cycle driven by a lowering: ``run_send`` issues the
    trainer's send_barrier on a thread (it returns once the server has
    served), the server drains and serves, then ``run_fetch``."""
    th = threading.Thread(target=run_send)
    th.start()
    grads = srv.wait_grads()
    srv.serve()
    th.join(timeout=30)
    assert not th.is_alive()
    run_fetch()
    return grads


def _case_send_barrier(rs):
    from paddle_tpu.ops.distributed_ops import client_for as jax_client
    from paddle_tpu_torch.ops.distributed_ops import client_for

    for op_type in ("send_barrier", "fetch_barrier"):
        got = {}
        for pkg in ("jax", "port"):
            srv = RPCServer(port=0, num_trainers=1, sync=True)
            srv.start()
            ep = "127.0.0.1:%d" % srv.port
            cli = (jax_client if pkg == "jax" else client_for)(ep)
            outs = {}

            def lowered(t, pkg=pkg, ep=ep):
                outs.update(_lowered(pkg, t, {}, {"endpoints": [ep]}))

            try:
                if op_type == "send_barrier":
                    grads = _barrier_cycle(srv, lambda: lowered(op_type),
                                           cli.fetch_barrier)
                else:
                    grads = _barrier_cycle(srv, cli.send_barrier,
                                           lambda: lowered(op_type))
            finally:
                _reset_pools()
                srv.close()
            got[pkg] = (outs, grads)
        for pkg, (outs, grads) in got.items():
            _flag_ok(outs)
            assert grads == [], (op_type, pkg)


def _case_recv(rs):
    # an int64 var: the port narrows it to int32 on the device, as every
    # int64 var runs; the JAX package's callback cannot declare an int64
    # result with x64 off, so that case is the port's alone
    ids = rs.randint(-5, 5, (6,)).astype(np.int64)

    srv = RPCServer(port=0, num_trainers=1, sync=False)
    srv.start()
    try:
        srv.set_var("ids", ids)
        (got,) = _lowered("port", "recv", {}, {
            "endpoint": "127.0.0.1:%d" % srv.port, "var_name": "ids",
            "shape": [6], "dtype": "int64"})["Out"]
    finally:
        _reset_pools()
        srv.close()
    assert got.dtype == np.int32 and np.array_equal(got, ids)
    for arr in (rs.randn(4, 3).astype(np.float32),
                rs.randint(-5, 5, (6,)).astype(np.int32),
                np.array(2.5, np.float32)):
        def serve(srv, run, arr=arr):
            srv.set_var("w", arr)
            run()

        got = _both_against(
            "recv", {}, {"endpoint": None, "var_name": "w",
                         "shape": list(arr.shape), "dtype": str(arr.dtype)},
            serve)
        outs = {pkg: got[pkg][0]["Out"][0] for pkg in got}
        assert _bits(outs["port"]) == _bits(outs["jax"])
        assert np.array_equal(outs["port"], arr)


def _case_prefetch(rs):
    table = rs.randn(10, 4).astype(np.float32)
    for ids, pad in ((rs.randint(0, 10, (5, 3, 1)).astype(np.int64), -1),
                     (np.array([[2, 7], [2, 0]], np.int64), 2),
                     (rs.randint(0, 10, (6,)).astype(np.int64), 5)):
        def serve(srv, run):
            srv.set_var("tbl", table)
            run()

        got = _both_against(
            "prefetch", {"Ids": [ids]},
            {"endpoint": None, "table_name": "tbl", "width": 4,
             "dtype": "float32", "padding_idx": pad}, serve)
        outs = {pkg: got[pkg][0]["Out"][0] for pkg in got}
        assert _bits(outs["port"]) == _bits(outs["jax"])
        flat = ids.reshape(ids.shape[:-1] if ids.shape[-1:] == (1,)
                           and ids.ndim >= 2 else ids.shape)
        want = np.where((flat != pad)[..., None], table[flat], 0)
        np.testing.assert_array_equal(outs["port"], want)


@pytest.mark.parametrize("op_type", DIST_OPS)
def test_op_matches_jax_lowering(op_type):
    """Each PS op's lowering, the port's and the JAX package's, against a
    live port server: the same outputs (shape, dtype, bits) and the same
    values arriving at the server (dense, SelectedRows with pad rows
    zeroed, the barriers' cycles)."""
    {"send": _case_send, "send_sparse": _case_send_sparse,
     "send_barrier": _case_send_barrier,
     "fetch_barrier": _case_send_barrier, "recv": _case_recv,
     "prefetch": _case_prefetch}[op_type](np.random.RandomState(0))


# ------------------------------------------------ real processes (slow)
def _worker_env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _spawn(env):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _wait_file(path, timeout=120, procs=()):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            with open(path) as f:
                data = f.read().strip()
            if data:
                return data
        except OSError:
            pass
        for p in procs:
            if p.poll() is not None:
                raise RuntimeError("a pserver exited before it bound:\n%s"
                                   % p.communicate()[0].decode())
        time.sleep(0.05)
    raise RuntimeError("timed out waiting for %s" % path)


def _start_pservers(tmp_path, n, base):
    """``n`` pserver processes, each binding port 0 itself and reporting
    its endpoint through a file; the joined list is published to them.
    Returns (processes, endpoints)."""
    eps_file = str(tmp_path / "endpoints")
    procs, files = [], []
    for i in range(n):
        pf = str(tmp_path / ("ps%d.endpoint" % i))
        files.append(pf)
        procs.append(_spawn(_worker_env(
            **base, PADDLE_TRAINING_ROLE="PSERVER",
            PADDLE_TPU_PS_PORT_FILE=pf,
            PADDLE_TPU_PS_ENDPOINTS_FILE=eps_file)))
    eps = ",".join(_wait_file(f, procs=procs) for f in files)
    with open(eps_file + ".tmp", "w") as f:
        f.write(eps)
    os.replace(eps_file + ".tmp", eps_file)
    return procs, eps


def _finish(procs, timeout=300):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
            assert p.returncode == 0, "worker failed:\n%s" % outs[-1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _run_cluster(tmp_path, model, n_ps, n_trainers, sync=True,
                 min_block_size=8192):
    base = dict(DIST_MODEL=model, PADDLE_TRAINERS_NUM=n_trainers,
                PADDLE_SYNC_MODE=int(sync), MIN_BLOCK_SIZE=min_block_size)
    procs, eps = _start_pservers(tmp_path, n_ps, base)
    files = []
    for i in range(n_trainers):
        files.append(str(tmp_path / ("loss_%d.json" % i)))
        procs.append(_spawn(_worker_env(
            **base, PADDLE_TRAINING_ROLE="TRAINER", PADDLE_TRAINER_ID=i,
            PADDLE_PSERVER_ENDPOINTS=eps, LOSS_OUT=files[-1])))
    _finish(procs)
    return [json.load(open(f)) for f in files]


def _lr_single():
    return _single_losses(_lr_build, [dict(zip(("x", "y"), _lr_data(s)))
                                      for s in range(LR_STEPS)])


@pytest.mark.slow
def test_sync_ps_matches_single_process(tmp_path):
    """2 trainers x half batch, grads averaged on the pserver == one
    process x full batch."""
    losses = _run_cluster(tmp_path, "lr", 1, 2)
    np.testing.assert_allclose(np.mean(losses, axis=0), _lr_single(),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.slow
def test_sync_ps_sliced_two_pservers(tmp_path):
    losses = _run_cluster(tmp_path, "lr", 2, 2, min_block_size=2)
    np.testing.assert_allclose(np.mean(losses, axis=0), _lr_single(),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.slow
def test_async_ps_converges_across_processes(tmp_path):
    losses = _run_cluster(tmp_path, "lr", 1, 2, sync=False)
    avg = np.mean(losses, axis=0)
    assert min(avg[1:]) < avg[0], losses


@pytest.mark.slow
def test_dist_ctr_sparse_table_cluster_matches_single(tmp_path):
    """DeepFM with distributed sparse tables, 2 trainers x half batch
    against 2 pservers, tracks the single-process full-batch run."""
    losses = _run_cluster(tmp_path, "ctr", 2, 2, min_block_size=64)
    single = _single_losses(lambda: _ctr_build(distributed=False),
                            [_ctr_data(s) for s in range(CTR_STEPS)])
    np.testing.assert_allclose(np.mean(losses, axis=0), single, rtol=2e-3,
                               atol=2e-4)
    assert single[-1] < single[0]


def _fault_cluster(tmp_path, n_steps, deadline_ms=2000, trainer_env=None,
                   port=None):
    """One pserver and one trainer as processes, with a progress file and
    a short RPC deadline: (pserver, trainer, progress file, loss file,
    the pserver's endpoint)."""
    base = dict(DIST_MODEL="lr", PADDLE_TRAINERS_NUM=1, PADDLE_SYNC_MODE=1,
                PADDLE_TPU_RPC_DEADLINE_MS=deadline_ms)
    (pserver,), eps = _start_pservers(tmp_path, 1, base)
    progress = str(tmp_path / "progress.txt")
    loss_f = str(tmp_path / "loss.json")
    trainer = _spawn(_worker_env(
        **base, PADDLE_TRAINING_ROLE="TRAINER", PADDLE_TRAINER_ID=0,
        PADDLE_PSERVER_ENDPOINTS=eps, DIST_STEPS=n_steps,
        PROGRESS_OUT=progress, LOSS_OUT=loss_f, **(trainer_env or {})))
    return pserver, trainer, progress, loss_f, eps, base


def _wait_steps(progress, n, timeout=120):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            with open(progress) as f:
                if len(f.read().split()) >= n:
                    return True
        except OSError:
            pass
        time.sleep(0.2)
    return False


@pytest.mark.slow
def test_pserver_death_surfaces_named_error_fast(tmp_path):
    """SIGKILL the pserver mid-run: the trainer exits non-zero with the
    named RPC error within the deadline, no hang."""
    import signal

    pserver, trainer, progress, _, _, _ = _fault_cluster(
        tmp_path, 500, trainer_env={"STEP_SLEEP": "0.3"})
    try:
        assert _wait_steps(progress, 2), "trainer never reached step 2"
        pserver.send_signal(signal.SIGKILL)
        pserver.wait()
        assert len(open(progress).read().split()) < 500
        t0 = time.time()
        out, _ = trainer.communicate(timeout=90)
        elapsed = time.time() - t0
        text = out.decode(errors="replace")
        assert trainer.returncode != 0, text
        assert ("RPCError" in text or "PeerGoneError" in text) \
            and "unreachable" in text, text
        assert elapsed < 75, "took %.0fs to surface the error" % elapsed
    finally:
        for p in (pserver, trainer):
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.slow
def test_pserver_restart_resumes_from_checkpoint(tmp_path):
    """Kill the pserver mid-run and restart it on the same endpoint with
    PADDLE_TPU_PS_RECOVER_DIR at the checkpoint-notify snapshots: the
    surviving trainer reconnects and finishes every step."""
    import signal

    ckpt = str(tmp_path / "ckpt")
    n_steps = 12
    pserver, trainer, progress, loss_f, eps, base = _fault_cluster(
        tmp_path, n_steps, trainer_env={"CKPT_DIR": ckpt,
                                        "RETRY_ON_RPC_ERROR": "1",
                                        "STEP_SLEEP": "0.4"})
    pserver2 = None
    try:
        assert _wait_steps(progress, 3), "trainer never reached step 3"
        pserver.send_signal(signal.SIGKILL)
        pserver.wait()
        assert len(open(progress).read().split()) < n_steps
        pserver2 = _spawn(_worker_env(
            **base, PADDLE_TRAINING_ROLE="PSERVER",
            PADDLE_PSERVER_ENDPOINTS=eps, PADDLE_CURRENT_ENDPOINT=eps,
            PADDLE_TPU_PS_RECOVER_DIR=ckpt))
        out, _ = trainer.communicate(timeout=180)
        text = out.decode(errors="replace")
        assert trainer.returncode == 0, text
        assert "R" in open(progress).read().split(), text
        losses = json.load(open(loss_f))
        assert len(losses) == n_steps
        assert losses[-1] < losses[0], losses
        assert all(np.isfinite(losses)), losses
    finally:
        for p in (pserver, trainer, pserver2):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()


# -------------------------------------------- the cluster worker process
def _worker():
    """One process of a cluster: a PSERVER or a TRAINER of DIST_MODEL
    ("lr" or "ctr"), topology from the PADDLE_* env, on the CPU. A
    pserver with PADDLE_TPU_PS_PORT_FILE binds port 0 itself and waits
    for the endpoint list; a trainer writes its losses to LOSS_OUT. The
    fault knobs: DIST_STEPS, PROGRESS_OUT (a line a step), CKPT_DIR
    (checkpoint_notify every step), RETRY_ON_RPC_ERROR (pull the params
    back and retry a step that failed on the wire), STEP_SLEEP."""
    from paddle_tpu_torch.ops.distributed_ops import client_for, reset_clients

    role = os.environ["PADDLE_TRAINING_ROLE"]
    trainers = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    sync = os.environ.get("PADDLE_SYNC_MODE", "1") == "1"
    ctr = os.environ.get("DIST_MODEL", "lr") == "ctr"
    port_file = os.environ.get("PADDLE_TPU_PS_PORT_FILE")
    if role == "PSERVER" and port_file:
        srv = RPCServer(port=0, num_trainers=trainers, sync=sync)
        ep = "127.0.0.1:%d" % srv.port
        with open(port_file + ".tmp", "w") as f:
            f.write(ep)
        os.replace(port_file + ".tmp", port_file)
        os.environ["PADDLE_PSERVER_ENDPOINTS"] = _wait_file(
            os.environ["PADDLE_TPU_PS_ENDPOINTS_FILE"])
        os.environ["PADDLE_CURRENT_ENDPOINT"] = ep
        ps_runtime.register_prebound_server(ep, srv)
    pservers = os.environ["PADDLE_PSERVER_ENDPOINTS"]
    main, startup, loss = _ctr_build() if ctr else _lr_build()
    cfg = fluid.DistributeTranspilerConfig()
    cfg.min_block_size = int(os.environ.get("MIN_BLOCK_SIZE", "8192"))
    t = fluid.DistributeTranspiler(cfg)
    t.transpile(trainer_id=trainer_id, program=main, pservers=pservers,
                trainers=trainers, sync_mode=sync, startup_program=startup)
    exe = _cpu()
    if role == "PSERVER":
        ep = os.environ["PADDLE_CURRENT_ENDPOINT"]
        exe.run(t.get_startup_program(ep))
        exe.run(t.get_pserver_program(ep))
        return
    prog = t.get_trainer_program()
    exe.run(t.get_trainer_startup_program())
    steps = int(os.environ.get("DIST_STEPS", CTR_STEPS if ctr else LR_STEPS))
    progress = os.environ.get("PROGRESS_OUT")
    ckpt_dir = os.environ.get("CKPT_DIR")
    retry = os.environ.get("RETRY_ON_RPC_ERROR") == "1"
    step_sleep = float(os.environ.get("STEP_SLEEP", "0"))
    losses, step, failures, recovery = [], 0, 0, None
    while step < steps:
        if ctr:
            feed = _ctr_data(step)
        else:
            X, Y = _lr_data(step)
            feed = {"x": X, "y": Y}
        # each trainer takes its share of the global batch
        feed = {k: v[trainer_id::trainers] for k, v in feed.items()}
        try:
            lv, = exe.run(prog, feed=feed, fetch_list=[loss])
        except Exception as exc:
            if not retry or ("RPCError" not in repr(exc)
                             and "PeerGoneError" not in repr(exc)):
                raise
            failures += 1
            if failures > 20:
                raise
            reset_clients()
            time.sleep(0.5)
            recovery = recovery or t.get_trainer_recovery_program()
            while True:
                try:
                    exe.run(recovery)
                    break
                except Exception:
                    failures += 1
                    if failures > 20:
                        raise
                    reset_clients()
                    time.sleep(0.5)
            if progress:
                with open(progress, "a") as f:
                    f.write("R\n")
            continue
        failures = 0
        losses.append(float(lv))
        if ckpt_dir:
            for ep in pservers.split(","):
                client_for(ep).checkpoint_notify(ckpt_dir)
        if progress:
            with open(progress, "a") as f:
                f.write("%d\n" % step)
        time.sleep(step_sleep)
        step += 1
    exe.close()
    out = os.environ.get("LOSS_OUT")
    if out:
        with open(out, "w") as f:
            json.dump(losses, f)


if __name__ == "__main__":
    _worker()
    sys.exit(0)
