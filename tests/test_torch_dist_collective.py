"""The data axis across trainer processes (paddle_tpu_torch/parallel:
env, mesh, collective, partition) on the CPU.

Two gloo ranks of 4 ``CPUPlace()`` positions each, a global (data 8)
mesh, are started once for the module through the port's launcher
(``python -m paddle_tpu_torch.distributed.launch --nproc 2 <this
file>``): this file is their program when run as ``__main__``, and it
imports no JAX there. Every rank feeds the global batch. The ranks run
three programs from the JAX package's post-startup state and write what
they fetched; the tests hold it to the JAX package's single-process run
of the same program on the same feeds (the test process), as
tests/test_dist_collective.py holds the JAX package's own cross-host
run:

- (a) dist_collective_script.py's linear regression: features 8, Adam
  with ``ShardingRules(zero1=True)``, 5 ``run`` steps and a
  ``run_repeated(steps=3)``, the transpiler's nccl2 mode over it; losses
  within rtol 2e-4, atol 1e-5 (tests/test_dist_collective.py:101), each
  rank's moment its 4 of the 8 rows;
- (b) a 2-layer BERT (d 64, S 16, global batch 8) with is_test dropout,
  which gathers its MLM rows from the global batch: losses within 1e-5
  of the JAX package's, once with each rank's mask ids in its own rows
  and once with half of them in the other rank's (so the gather's
  backward, a reduce-scatter, carries the other rank's addends); then
  with dropout 0.1 against the port's single-process run: the dropout
  masks bitwise, losses within 1e-6;
- (c) conv + batch_norm + pool + fc with ``accuracy``, through
  ``CompiledProgram`` and ``ParallelExecutor(num_trainers, trainer_id)``:
  losses, accuracy and the running statistics against the JAX package's;
- (d) a max, a min and a mean over the rows, trained with SGD, against
  the JAX package's.

In-process (no ranks): an op with no row rule raises at plan time naming
it, a model axis across ranks raises, and the backend choice with a
faked visible-card count.
"""

import json
import os
import socket
import importlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANKS, POSITIONS = 2, 4
LR_FEATURES, LR_STEPS, LR_REPEAT = 8, 5, 3
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5  # tests/test_dist_collective.py:101
BERT_CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
                type_vocab=2, max_length=16, dropout=0.1)
BERT_SEQ, BERT_MASK, BERT_BATCH, BERT_STEPS = 16, 4, 8, 3
BERT_JAX_TOL, BERT_PORT_TOL = 1e-5, 1e-6
BN_BATCH, BN_STEPS, BN_TOL = 16, 3, 1e-5
RANK_TIMEOUT_S = 240


# ------------------------------------------------ the programs (either
# package's layers: ``pkg`` is paddle_tpu or paddle_tpu_torch)
def lr_program(pkg):
    """dist_lr_script.build(Adam, features=8) in ``pkg``."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[LR_FEATURES], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(
            x, size=1,
            param_attr=pkg.ParamAttr(
                name="fc_w", initializer=pkg.initializer.Constant(0.5)),
            bias_attr=pkg.ParamAttr(
                name="fc_b", initializer=pkg.initializer.Constant(0.0)))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def lr_data(step):
    """dist_lr_script.data(step, features=8)."""
    rng = np.random.RandomState(100 + step)
    X = rng.randn(32, LR_FEATURES).astype(np.float32)
    W = np.linspace(-1, 1, LR_FEATURES).astype(np.float32).reshape(-1, 1)
    return {"x": X, "y": X @ W + 0.3}


def bert_program(pkg, is_test):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        bert = importlib.import_module(pkg.__name__ + ".models.bert")
        loss, _ = bert.build(dict(BERT_CFG), seq_len=BERT_SEQ,
                             max_mask=BERT_MASK, is_test=is_test)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def bert_masks(main):
    """The dropout masks' names, in program order."""
    return [op.output("Mask")[0] for op in main.global_block().ops
            if op.type in ("dropout", "fused_attention")
            and op.output("Mask")]


def bert_feed(step, cross=False):
    """Step ``step``'s batch; each row's mask ids pick tokens of its own
    sequence, or with ``cross`` every second id picks from the sequence
    half a batch away, which the other rank holds."""
    rs = np.random.RandomState(40 + step)
    B, S, M = BERT_BATCH, BERT_SEQ, BERT_MASK
    mask = np.ones((B, S), np.float32)
    mask[:, S - 3:] = 0.0
    feed = {"src_ids": rs.randint(1, BERT_CFG["vocab"], (B, S)),
            "sent_ids": rs.randint(0, 2, (B, S)),
            "input_mask": mask,
            "mask_pos": (np.arange(B)[:, None] * S
                         + rs.randint(0, S - 3, (B, M))).astype(np.int64),
            "mask_label": rs.randint(0, BERT_CFG["vocab"], (B, M)),
            "mask_weight": np.ones((B, M), np.float32)}
    if cross:
        pos = feed["mask_pos"]
        pos[:, 1::2] = (pos[:, 1::2] + (B // 2) * S) % (B * S)
    return feed


def bn_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data("img", [2, 8, 8])
        label = pkg.layers.data("label", [1], dtype="int64")
        c = pkg.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
        b = pkg.layers.batch_norm(c, act="relu")
        p = pkg.layers.pool2d(b, pool_size=2, pool_stride=2)
        probs = pkg.layers.fc(p, size=5, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(probs, label))
        acc = pkg.layers.accuracy(probs, label)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, acc


def bn_stats(main):
    return sorted(v.name for v in main.list_vars() if v.persistable
                  and ("batch_norm" in v.name) and
                  (v.name.endswith(".w_1") or v.name.endswith(".w_2")))


def bn_feed(step):
    rs = np.random.RandomState(60 + step)
    return {"img": rs.randn(BN_BATCH, 2, 8, 8).astype(np.float32),
            "label": rs.randint(0, 5, (BN_BATCH, 1)).astype(np.int64)}


def reduce_program(pkg):
    """Reductions over the rows: a max, a min and a mean over dim 0, and
    a sum of all, with SGD."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [6])
        h = pkg.layers.fc(x, size=4, act="tanh")
        top = pkg.layers.reduce_max(h, dim=[0])
        low = pkg.layers.reduce_min(h, dim=[0])
        avg = pkg.layers.reduce_mean(h, dim=[0])
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_sub(
            pkg.layers.elementwise_add(pkg.layers.scale(top, scale=0.5),
                                       avg),
            pkg.layers.scale(low, scale=0.25)))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def reduce_feed(step):
    return {"x": np.random.RandomState(80 + step).randn(
        BN_BATCH, 6).astype(np.float32)}


# ------------------------------------------------------ the ranks' side
def _wait_file(path, timeout_s=RANK_TIMEOUT_S):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise RuntimeError("timed out waiting for %s" % path)
        time.sleep(0.02)
    return path


def _port_scope(pt, main, state_file):
    from paddle_tpu_torch.convert import params_from_jax

    with np.load(_wait_file(state_file)) as z:
        state = {n: z[n] for n in z.files}
    scope = pt.Scope()
    for n, t in params_from_jax(state, main, torch.device("cpu")).items():
        scope.set_var(n, t)
    return scope


def _first(v):
    return float(np.asarray(v).reshape(-1)[0])


def _rank_lr(pt, penv, out):
    from paddle_tpu_torch.parallel import ParallelEngine, ShardingRules

    main, startup, loss = lr_program(pt)
    cfg = pt.DistributeTranspilerConfig()
    cfg.mode = "nccl2"
    t = pt.DistributeTranspiler(cfg)
    t.transpile(trainer_id=penv.rank, program=main, pservers="",
                trainers=",".join(penv.trainer_endpoints), sync_mode=True,
                startup_program=startup)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    engine = ParallelEngine(main, loss_name=loss.name,
                            places=[pt.CPUPlace()] * POSITIONS,
                            rules=ShardingRules(zero1=True))
    losses = [_first(engine.run(lr_data(s), [loss.name], scope)[0])
              for s in range(LR_STEPS)]
    losses.append(_first(engine.run_repeated(
        lr_data(LR_STEPS), [loss.name], scope, steps=LR_REPEAT)[0]))
    plan = next(iter(engine._cache.values()))
    moment = [n for n in plan.state_specs if "_moment1_" in n and "fc_w" in n]
    local = scope.find_var(moment[0])
    # a ZeRO-1 slot fetched whole (all-gathered), and one local position's
    # block of it; another rank's position refuses
    (whole,) = engine.run(lr_data(0), [moment[0]], scope)
    p = penv.rank * POSITIONS + 1
    try:
        engine.shard(moment[0], ((1 - penv.rank) * POSITIONS,), scope)
        refused = False
    except ValueError:
        refused = True
    out["lr_shard"] = dict(
        whole=np.asarray(whole).tolist(), position=p,
        block=engine.shard(moment[0], (p,), scope).numpy().tolist(),
        other_refused=refused)
    out["lr"] = dict(
        losses=losses, spec=str(plan.state_specs[moment[0]]),
        moment_rows=int(local.shape[0]),
        mesh=dict(engine.mesh.shape), world=engine.mesh.world,
        uncaptured=plan.host_sync, feed_specs={
            n: str(s) for n, s in plan.feed_specs.items()},
        lines=engine.lowered_collectives(lr_data(0), [loss.name], scope)
        .splitlines()[:2])


def _rank_bert(pt, penv, out, d):
    from paddle_tpu_torch.parallel import ParallelEngine

    for key, is_test, cross in (("bert_test", True, False),
                                ("bert_cross", True, True),
                                ("bert_dropout", False, False)):
        main, _, loss = bert_program(pt, is_test)
        scope = _port_scope(pt, main, os.path.join(
            d, "cross.npz" if cross else "bert.npz"))
        engine = ParallelEngine(main, loss_name=loss.name,
                                places=[pt.CPUPlace()] * POSITIONS)
        masks = [] if is_test else bert_masks(main)
        losses, got = [], {}
        for s in range(BERT_STEPS):
            vals = engine.run(bert_feed(s, cross), [loss.name] + masks,
                              scope)
            losses.append(_first(vals[0]))
            if s == 0:
                got = {m: v for m, v in zip(masks, vals[1:])}
        out[key] = losses
        if not is_test:
            np.savez(os.path.join(d, "masks%d.npz" % penv.rank), **got)


def _rank_bn(pt, penv, out, state_file):
    main, _, loss, acc = bn_program(pt)
    scope = _port_scope(pt, main, state_file)
    compiled = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[pt.CPUPlace()] * POSITIONS)
    exe = pt.Executor(pt.CPUPlace())
    losses, accs = [], []
    for s in range(BN_STEPS - 1):
        lv, av = exe.run(compiled, feed=bn_feed(s), fetch_list=[loss, acc],
                         scope=scope)
        losses.append(_first(lv))
        accs.append(_first(av))
    pe = pt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             main_program=main, scope=scope,
                             num_trainers=penv.world_size,
                             trainer_id=penv.rank)
    lv, av = pe.run([loss.name, acc.name], feed=bn_feed(BN_STEPS - 1))
    losses.append(_first(lv))
    accs.append(_first(av))
    out["bn"] = dict(losses=losses, accs=accs,
                     positions=[compiled._engine.device_count,
                                pe.device_count],
                     stats={n: scope.find_var(n).numpy().tolist()
                            for n in bn_stats(main)})


def _rank_collectives(penv, out):
    """The four differentiable collectives on 2 ranks, their values and
    their vjps (``torch.func.vjp``, as the generic grads take them)."""
    from paddle_tpu_torch.parallel import collective as c

    comm = c.Comm(penv.rank, penv.world_size)
    r = float(penv.rank)
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    cot = torch.full((2, 3), r + 1)
    got = {}
    for grad in ("identity", "sum"):
        y, vjp = torch.func.vjp(lambda t: c.all_reduce(t, comm, grad=grad), x)
        got["all_reduce_" + grad] = [y.tolist(), vjp(cot)[0].tolist()]
    m = torch.tensor([r, 1.0 - r, 2.0])
    y, vjp = torch.func.vjp(lambda t: c.all_reduce(t, comm, op="max"), m)
    got["all_reduce_max"] = [y.tolist(), vjp(torch.ones(3))[0].tolist()]
    for grad in ("reduce_scatter", "slice"):
        y, vjp = torch.func.vjp(
            lambda t: c.all_gather_rows(t, comm, grad=grad), x)
        got["all_gather_" + grad] = [y.tolist(), vjp(
            torch.full((4, 3), r + 1))[0].tolist()]
    y, vjp = torch.func.vjp(lambda t: c.reduce_scatter_rows(t, comm),
                            torch.ones(4, 3) * (r + 1))
    got["reduce_scatter"] = [y.tolist(), vjp(cot)[0].tolist()]
    y, vjp = torch.func.vjp(lambda t: c.broadcast(t, comm, 0), x)
    got["broadcast"] = [y.tolist(), vjp(cot)[0].tolist()]
    out["collectives"] = got


def _rank_reduce(pt, penv, out, state_file):
    from paddle_tpu_torch.parallel import ParallelEngine

    main, _, loss = reduce_program(pt)
    scope = _port_scope(pt, main, state_file)
    engine = ParallelEngine(main, loss_name=loss.name,
                            places=[pt.CPUPlace()] * POSITIONS)
    out["reduce"] = [_first(engine.run(reduce_feed(s), [loss.name],
                                       scope)[0]) for s in range(BN_STEPS)]


def _rank_main():
    """One trainer rank (started by the launcher): the three programs
    (each from the state file the test process writes, once it is
    there), what it fetched written to ``XPROC_DIR/rank<r>.json``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.env import init_parallel_env

    torch.set_num_threads(1)
    d = os.environ["XPROC_DIR"]
    penv = init_parallel_env(place=pt.CPUPlace())
    out = dict(rank=penv.rank, backend=penv.backend)
    _rank_collectives(penv, out)
    _rank_lr(pt, penv, out)
    _rank_bert(pt, penv, out, d)
    _rank_bn(pt, penv, out, os.path.join(d, "bn.npz"))
    _rank_reduce(pt, penv, out, os.path.join(d, "reduce.npz"))
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "paddle_tpu"))
    with open(os.path.join(d, "rank%d.json" % penv.rank), "w") as f:
        json.dump(out, f)


# ------------------------------------------------------ the test side
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_start(jf, build, path, *args):
    """Run ``build(jf)``'s startup in the JAX package and save its
    persistables to ``path`` (whole: written aside, then renamed);
    (main, executor, scope, the fetch vars)."""
    main, startup, *fetch = build(jf, *args)
    exe, scope = jf.Executor(jf.CPUPlace()), jf.Scope()
    exe.run(startup, scope=scope)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{v.name: np.asarray(scope.find_var(v.name))
                     for v in main.list_vars()
                     if v.persistable and scope.find_var(v.name)
                     is not None})
    os.replace(tmp, path)
    return main, exe, scope, fetch


def _references(jf, pt, d):
    """The single-process runs the ranks are held to, made while they
    run: the JAX package's (a), (b) and (c), and the port's (b) with
    dropout (its masks)."""
    ref = {}
    bert = _jax_start(jf, bert_program, os.path.join(d, "bert.npz"), True)
    cross = _jax_start(jf, bert_program, os.path.join(d, "cross.npz"), True)
    bn = _jax_start(jf, bn_program, os.path.join(d, "bn.npz"))
    red = _jax_start(jf, reduce_program, os.path.join(d, "reduce.npz"))

    main, startup, loss = lr_program(jf)
    exe, scope = jf.Executor(jf.CPUPlace()), jf.Scope()
    exe.run(startup, scope=scope)
    def run(feed):
        return _first(exe.run(main, feed=feed, fetch_list=[loss.name],
                              scope=scope)[0])

    ref["lr"] = [run(lr_data(s)) for s in range(LR_STEPS)]
    for _ in range(LR_REPEAT):
        last = run(lr_data(LR_STEPS))
    ref["lr"].append(last)

    for key, start, c in (("bert_test", bert, False),
                          ("bert_cross", cross, True)):
        main, exe, scope, (loss,) = start
        ref[key] = [_first(exe.run(
            main, feed=bert_feed(s, c), fetch_list=[loss.name],
            scope=scope)[0]) for s in range(BERT_STEPS)]

    main, _, loss = bert_program(pt, False)
    scope = _port_scope(pt, main, os.path.join(d, "bert.npz"))
    exe = pt.Executor(pt.CPUPlace())
    ref["masks"] = bert_masks(main)
    ref["bert_dropout"] = []
    for s in range(BERT_STEPS):
        vals = exe.run(main, feed=bert_feed(s),
                       fetch_list=[loss] + ref["masks"], scope=scope)
        ref["bert_dropout"].append(_first(vals[0]))
        if s == 0:
            ref["mask_values"] = vals[1:]

    main, exe, scope, (loss, acc) = bn
    ref["bn_losses"], ref["bn_accs"] = [], []
    for s in range(BN_STEPS):
        lv, av = exe.run(main, feed=bn_feed(s), fetch_list=[loss, acc],
                         scope=scope)
        ref["bn_losses"].append(_first(lv))
        ref["bn_accs"].append(_first(av))
    ref["bn_stats"] = {n: np.asarray(scope.find_var(n))
                       for n in bn_stats(main)}

    main, exe, scope, (loss,) = red
    ref["reduce"] = [_first(exe.run(main, feed=reduce_feed(s),
                                    fetch_list=[loss], scope=scope)[0])
                     for s in range(BN_STEPS)]
    return ref


class _Ranks:
    """The launched ranks, what each wrote and the references."""

    def __init__(self, d, proc, log, ref):
        self.dir, self.proc, self.log, self.ref = d, proc, log, ref
        self._out = None

    def out(self, rank):
        if self._out is None:
            try:
                self.proc.wait(timeout=RANK_TIMEOUT_S)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
                    self.proc.wait()
            with open(self.log) as f:
                log = f.read()
            assert self.proc.returncode == 0, "the ranks failed:\n" + \
                log[-6000:]
            self._out = []
            for r in range(RANKS):
                with open(os.path.join(self.dir, "rank%d.json" % r)) as f:
                    self._out.append(json.load(f))
            self.log_text = log
        return self._out[rank]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks, started first: they run (a) while the test process
    writes the JAX package's start states for (b) and (c), which they
    wait for, and the references are made while they run."""
    import paddle_tpu as jf
    import paddle_tpu_torch as pt

    d = str(tmp_path_factory.mktemp("xproc"))
    env = dict(os.environ, XPROC_DIR=d, CPU_NUM=str(POSITIONS),
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    log = os.path.join(d, "ranks.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc", str(RANKS), "--started_port", str(_free_port()),
             os.path.abspath(__file__)],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        ref = _references(jf, pt, d)
        yield _Ranks(d, proc, log, ref)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_lr_zero1_across_ranks_matches_jax(ranks):
    """(a) Adam + ZeRO-1 over (data 8) on 2 ranks: the losses of 5 runs
    and a run_repeated(steps=3) those of the JAX package's single
    process; each rank's first moment holds its 4 of the 8 rows; the plan
    runs uncaptured."""
    for r in range(RANKS):
        got = ranks.out(r)["lr"]
        np.testing.assert_allclose(got["losses"], ranks.ref["lr"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert got["spec"] == "P('data')"
        assert got["moment_rows"] == LR_FEATURES // RANKS
        assert got["mesh"] == {"data": RANKS * POSITIONS}
        assert got["world"] == RANKS
        assert got["feed_specs"] == {"x": "P('data')", "y": "P('data')"}
        assert "xproc_collective" in got["uncaptured"]
        assert got["lines"][0].startswith("mesh data=8, 8 positions")
        assert got["lines"][1].startswith("xproc_")
    assert ranks.out(0)["lr"]["losses"] == ranks.out(1)["lr"]["losses"]
    wholes = [np.asarray(ranks.out(r)["lr_shard"]["whole"])
              for r in range(RANKS)]
    for r in range(RANKS):
        got = ranks.out(r)["lr_shard"]
        assert wholes[r].shape == (LR_FEATURES, 1)
        np.testing.assert_array_equal(wholes[r], wholes[0])
        np.testing.assert_array_equal(
            got["block"], wholes[r][got["position"]:got["position"] + 1])
        assert got["other_refused"]


def test_collectives_and_their_vjps(ranks):
    """Each collective's value and its vjp on each rank: an all-reduce's
    backward the identity or an all-reduce, a max's to the rank holding
    it, an all-gather's a reduce-scatter or a slice, a reduce-scatter's an
    all-gather, a broadcast's the sum back to its source."""
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(RANKS)]
    total = x[0] + x[1]
    for r in range(RANKS):
        got = {k: [np.asarray(a) for a in v]
               for k, v in ranks.out(r)["collectives"].items()}
        cot = np.full((2, 3), r + 1.0)
        np.testing.assert_array_equal(got["all_reduce_identity"][0], total)
        np.testing.assert_array_equal(got["all_reduce_identity"][1], cot)
        np.testing.assert_array_equal(got["all_reduce_sum"][1],
                                      np.full((2, 3), 3.0))
        np.testing.assert_array_equal(got["all_reduce_max"][0],
                                      [1.0, 1.0, 2.0])
        # rank 0 holds the max of entry 1, rank 1 of entry 0; entry 2 ties
        np.testing.assert_array_equal(got["all_reduce_max"][1],
                                      [r, 1.0 - r, 0.5])
        whole = np.concatenate(x)
        for k in ("all_gather_reduce_scatter", "all_gather_slice"):
            np.testing.assert_array_equal(got[k][0], whole)
        np.testing.assert_array_equal(got["all_gather_reduce_scatter"][1],
                                      np.full((2, 3), 3.0))
        np.testing.assert_array_equal(got["all_gather_slice"][1], cot)
        np.testing.assert_array_equal(got["reduce_scatter"][0],
                                      np.full((2, 3), 3.0))
        np.testing.assert_array_equal(
            got["reduce_scatter"][1],
            np.concatenate([np.full((2, 3), 1.0), np.full((2, 3), 2.0)]))
        np.testing.assert_array_equal(got["broadcast"][0], x[0])
        np.testing.assert_array_equal(got["broadcast"][1],
                                      np.full((2, 3), 3.0 * (r == 0)))


def test_ranks_import_no_jax_and_log_gloo(ranks):
    for r in range(RANKS):
        out = ranks.out(r)
        assert out["backend"] == "gloo" and out["jax_modules"] == []
    assert "process group over gloo (the CPU)" in ranks.log_text


def test_bert_gathers_rows_across_ranks(ranks):
    """(b) The 2-layer BERT, is_test dropout, against the JAX package's
    single process (its MLM head gathers from the global rows; each
    rank's mask ids pick from its own)."""
    for r in range(RANKS):
        np.testing.assert_allclose(ranks.out(r)["bert_test"],
                                   ranks.ref["bert_test"],
                                   rtol=BERT_JAX_TOL, atol=0)


def test_bert_mlm_picks_rows_of_the_other_rank(ranks):
    """(b) As above, with every second mask id in the other rank's rows:
    the gather's backward reduce-scatters those rows' cotangents to the
    rank that holds them, so the later steps' losses see it."""
    feed = bert_feed(0, cross=True)["mask_pos"]
    half = BERT_BATCH // RANKS * BERT_SEQ
    assert ((feed[:BERT_BATCH // RANKS] >= half).any()
            and (feed[BERT_BATCH // RANKS:] < half).any())
    for r in range(RANKS):
        np.testing.assert_allclose(ranks.out(r)["bert_cross"],
                                   ranks.ref["bert_cross"],
                                   rtol=BERT_JAX_TOL, atol=0)


def test_bert_dropout_masks_bitwise_the_single_process(ranks):
    """(b) With dropout 0.1, the ranks' masks (all-gathered) are the
    port's single-process masks bit for bit, and the losses within
    1e-6."""
    ref = ranks.ref
    assert len(ref["masks"]) == 1 + 3 * BERT_CFG["n_layer"]
    for r in range(RANKS):
        np.testing.assert_allclose(ranks.out(r)["bert_dropout"],
                                   ref["bert_dropout"], rtol=BERT_PORT_TOL,
                                   atol=0)
        with np.load(os.path.join(ranks.dir, "masks%d.npz" % r)) as z:
            for m, v in zip(ref["masks"], ref["mask_values"]):
                np.testing.assert_array_equal(z[m], v, err_msg=m)


def test_batch_norm_and_accuracy_across_ranks(ranks):
    """(c) conv + batch_norm + accuracy through CompiledProgram (2 steps)
    and ParallelExecutor(num_trainers=2, trainer_id) (1 step) over the
    global mesh, against the JAX package's single process."""
    ref = ranks.ref
    for r in range(RANKS):
        got = ranks.out(r)["bn"]
        assert got["positions"] == [RANKS * POSITIONS] * 2
        np.testing.assert_allclose(got["losses"], ref["bn_losses"],
                                   rtol=BN_TOL)
        np.testing.assert_array_equal(got["accs"], ref["bn_accs"])
        for n, v in got["stats"].items():
            np.testing.assert_allclose(v, ref["bn_stats"][n], rtol=BN_TOL,
                                       atol=BN_TOL, err_msg=n)


def test_reductions_over_rows_across_ranks(ranks):
    """``reduce_max`` / ``reduce_min`` / ``reduce_mean`` over dim 0 (an
    all-reduce max / min / sum across ranks, their grads to the rows
    that hold the extremes) and their SGD steps, against the JAX
    package's single process."""
    for r in range(RANKS):
        np.testing.assert_allclose(ranks.out(r)["reduce"],
                                   ranks.ref["reduce"], rtol=BN_TOL)


# ------------------------------------------------------ in-process
def _plan(program, fetch, feed_specs):
    """The cross-process plan of ``program`` for rank 0 of 2 (plan time
    only: no process group needed)."""
    from paddle_tpu_torch.parallel.collective import Comm
    from paddle_tpu_torch.parallel.partition import Partitioner

    names = sorted(feed_specs)
    state = sorted(v.name for v in program.list_vars() if v.persistable)
    return Partitioner(Comm(0, 2), "data", feed_specs, {}).plan(
        program, names, [fetch], state, [], [])


def test_an_op_without_a_row_rule_raises_at_plan_time():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.mesh import P
    from paddle_tpu_torch.parallel.partition import XPlanError

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", [4])
        out = pt.layers.cumsum(pt.layers.fc(x, 3), axis=0)
        loss = pt.layers.mean(out)
    with pytest.raises(XPlanError, match=r"op 'cumsum'.*no row rule"):
        _plan(main, loss.name, {"x": P("data")})
    # the same program whose feed stays whole needs no rule
    plan = _plan(main, loss.name, {"x": P()})
    assert plan.fetch_kinds == {loss.name: "repl"}
    # a transpose that moves the rows' dim raises too
    main2, startup2 = pt.Program(), pt.Program()
    with pt.program_guard(main2, startup2), pt.unique_name.guard():
        x = pt.layers.data("x", [4, 5], append_batch_size=True)
        t = pt.layers.transpose(x, [1, 0, 2])
    with pytest.raises(XPlanError, match=r"op 'transpose2'.*dim 0"):
        _plan(main2, t.name, {"x": P("data")})


def test_plan_kinds_of_a_training_step():
    """Rows through the forward, the loss whole, the params' grads
    partials all-reduced in one bucket before the first optimizer op."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.mesh import P

    main, _, loss = lr_program(pt)
    plan = _plan(main, loss.name, {"x": P("data"), "y": P("data")})
    ops = main.global_block().ops
    (at,) = [op for op in ops if id(op) in plan.pre]
    assert at.type == "adam" and plan.pre[id(at)] == ["fc_b@GRAD",
                                                      "fc_w@GRAD"]
    assert plan.fetch_kinds == {loss.name: "repl"}


def test_a_non_data_axis_across_ranks_raises():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.mesh import Mesh

    places = np.empty((2, 2), dtype=object)
    places[:] = [[pt.CPUPlace()] * 2] * 2
    # rank r holds row r: the leading axis crosses ranks
    ranks = np.array([[0, 0], [1, 1]])
    with pytest.raises(NotImplementedError, match="'model' crosses ranks"):
        Mesh(places, ("model", "data"), ranks, 0)
    with pytest.raises(NotImplementedError, match="no 'data' axis"):
        Mesh(places, ("seq", "model"), ranks, 0)
    mesh = Mesh(places, ("data", "model"), ranks, 1)
    assert mesh.world == 2 and mesh.is_local((1, 0))
    assert not mesh.is_local((0, 1)) and mesh.rank_of((0, 1)) == 0


def test_backend_choice_and_card_rank(monkeypatch):
    """gloo where 2 ranks share 1 visible card and on the CPU, NCCL
    where each rank has a card; a card rank with no card raises before
    it joins."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import collective
    from paddle_tpu_torch.parallel.env import ParallelEnv

    eps = "127.0.0.1:6170,127.0.0.1:6171"
    assert collective.choose_backend(eps.split(","), True, 1) == "gloo"
    assert collective.choose_backend(eps.split(","), True, 2) == "nccl"
    assert collective.choose_backend(eps.split(","), False, 8) == "gloo"
    assert collective.choose_backend(
        ["10.0.0.1:1", "10.0.0.2:1"], True, 1) == "nccl"
    penv = ParallelEnv({"PADDLE_TRAINER_ID": "1",
                        "PADDLE_TRAINER_ENDPOINTS": eps})
    monkeypatch.setattr(collective, "_LOGGED", ["logged"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    for cards, want in ((1, ("cuda:0", "gloo")), (2, ("cuda:1", "nccl"))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        dev, backend = collective.rank_device(penv)
        assert (str(dev), backend) == want
    assert collective.rank_device(penv, pt.CPUPlace()) == (
        torch.device("cpu"), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card rank, but no CUDA"):
        collective.rank_device(penv)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _rank_main()
    sys.exit(0)
