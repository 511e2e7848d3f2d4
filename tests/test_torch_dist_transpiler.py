"""The port's DistributeTranspiler (a copy of the JAX package's): the JAX
package's tests/test_dist_transpiler.py cases on Programs built by the
port's layers, and the programs the port's transpiler makes from the
port's layers held to the JAX package's from its own: op types, slots,
attrs (the pserver's nested optimize program and block specs
included), var names, shapes and dtypes, and the rewrite log. No
network."""

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as fluid
from paddle_tpu_torch.distributed.transpiler import slice_variable

EPS2 = "127.0.0.1:6170,127.0.0.1:6171"


def _build_net(pkg=fluid):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(
            x, size=1,
            param_attr=pkg.ParamAttr(
                name="fc_w", initializer=pkg.initializer.Constant(0.1)),
            bias_attr=pkg.ParamAttr(
                name="fc_b", initializer=pkg.initializer.Constant(0.0)))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_slice_variable():
    blocks = slice_variable("w", (10, 4), True, 8, 3)
    assert len(blocks) == 3
    assert [b.rows for b in blocks] == [4, 3, 3]
    assert [b.offset for b in blocks] == [0, 4, 7]
    assert blocks[0].block_name == "w.block0"
    assert blocks[0].grad_name == "w.block0@GRAD"
    assert len(slice_variable("w", (10, 4), True, 8192, 3)) == 1
    assert slice_variable("w", (10, 4), True, 8192, 3)[0].block_name == "w"
    assert len(slice_variable("w", (10, 4), False, 1, 3)) == 1


def test_trainer_program_structure():
    main, startup, loss = _build_net()
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers="1.1.1.1:6170",
                trainers=2, sync_mode=True, startup_program=startup)
    prog = t.get_trainer_program()
    types = [op.type for op in prog.global_block().ops]
    assert "sgd" not in types, "update ops must move to the pserver"
    assert types.count("send") == 2
    assert types.count("recv") == 2
    assert types.index("send_barrier") < types.index("recv")
    assert types[-1] == "fetch_barrier"
    orig_types = [op.type for op in main.global_block().ops]
    assert "sgd" in orig_types and "send" not in orig_types


def test_pserver_program_structure():
    main, startup, loss = _build_net()
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers="1.1.1.1:6170",
                trainers=2, sync_mode=True, startup_program=startup)
    ps = t.get_pserver_program("1.1.1.1:6170")
    op = ps.global_block().ops[0]
    assert op.type == "listen_and_serv"
    assert op.attrs["Fanin"] == 2 and op.attrs["sync_mode"] is True
    specs = {s["param_block"]: s for s in op.attrs["block_specs"]}
    assert set(specs) == {"fc_w", "fc_b"}
    assert specs["fc_w"]["shape"] == [8, 1]
    assert specs["fc_w"]["opt_type"] == "sgd"
    opt_types = [o.type for o in
                 op.attrs["optimize_program"].global_block().ops]
    assert opt_types == ["sgd", "sgd"]
    sp = t.get_startup_program("1.1.1.1:6170")
    fills = {o.output("Out")[0]: o.attrs["value"]
             for o in sp.global_block().ops if o.type == "fill_constant"}
    assert any(abs(v - 0.1) < 1e-9 for n, v in fills.items()
               if n.startswith("learning_rate"))


def test_sliced_param_split_concat():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(
            x, size=1,
            param_attr=fluid.ParamAttr(
                name="w", initializer=fluid.initializer.Constant(0.1)),
            bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    cfg = fluid.DistributeTranspilerConfig()
    cfg.min_block_size = 2
    t = fluid.DistributeTranspiler(cfg)
    eps = "1.1.1.1:6170,2.2.2.2:6170"
    t.transpile(trainer_id=0, program=main, pservers=eps, trainers=1,
                sync_mode=True, startup_program=startup)
    prog = t.get_trainer_program()
    types = [op.type for op in prog.global_block().ops]
    assert "split" in types and "concat" in types
    assert types.count("send") == 2 and types.count("recv") == 2
    ps1 = t.get_pserver_program("1.1.1.1:6170").global_block().ops[0]
    ps2 = t.get_pserver_program("2.2.2.2:6170").global_block().ops[0]
    names1 = {s["param_block"] for s in ps1.attrs["block_specs"]}
    names2 = {s["param_block"] for s in ps2.attrs["block_specs"]}
    assert names1 == {"w.block0"} and names2 == {"w.block1"}
    assert ps1.attrs["block_specs"][0]["shape"] == [3, 1]


def test_collective_mode_no_surgery():
    main, startup, loss = _build_net()
    cfg = fluid.DistributeTranspilerConfig()
    cfg.mode = "nccl2"
    t = fluid.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, trainers=2,
                startup_program=startup)
    assert t.get_trainer_program() is main


def test_rewrite_log_declares_splits_and_renames():
    main, startup, loss = _build_net()
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=EPS2, trainers=2,
                sync_mode=True, startup_program=startup)
    log = t.get_rewrite_log()
    assert log["mode"] == "pserver"
    assert log["trainers"] == 2 and log["sync_mode"] is True
    assert log["endpoints"] == EPS2.split(",")
    assert log["split_method"] == "RoundRobin"
    for split in log["splits"]:
        off = 0
        for b in sorted(split["blocks"], key=lambda b: b["idx"]):
            assert b["offset"] == off
            off += b["rows"]
            assert b["endpoint"] in log["endpoints"]
            assert log["endpoint_map"][b["name"]] == b["endpoint"]
        assert off == split["shape"][0]
        assert log["renames"][split["param"]] == [
            b["name"] for b in split["blocks"]]
        assert log["renames"][split["grad"]] == [
            b["grad"] for b in split["blocks"]]
    assert {r["type"] for r in log["removed_update_ops"]} == {"sgd"}
    declared = {b["name"] for s in log["splits"] for b in s["blocks"]}
    assert set(log["dispatch_order"]) == declared


def test_rewrite_log_requires_transpile():
    t = fluid.DistributeTranspiler()
    with pytest.raises(RuntimeError):
        t.get_rewrite_log()


def test_rewrite_log_collective_mode_is_empty():
    main, startup, loss = _build_net()
    cfg = fluid.DistributeTranspilerConfig()
    cfg.mode = "nccl2"
    t = fluid.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, trainers=2,
                startup_program=startup)
    log = t.get_rewrite_log()
    assert log["mode"] == "nccl2"
    assert log["splits"] == [] and log["removed_update_ops"] == []


def _snapshot(prog):
    blk = prog.global_block()
    return (
        [(op.type, sorted((s, tuple(n)) for s, n in op.inputs.items()),
          sorted((s, tuple(n)) for s, n in op.outputs.items()),
          sorted((k, repr(v)) for k, v in op.attrs.items()))
         for op in blk.ops],
        {n: (tuple(v.shape or ()), v.dtype, bool(v.persistable))
         for n, v in blk.vars.items()},
    )


def test_transpile_does_not_mutate_origin_programs():
    main, startup, loss = _build_net()
    before_main, before_startup = _snapshot(main), _snapshot(startup)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=EPS2, trainers=2,
                sync_mode=True, startup_program=startup)
    t.get_trainer_program()
    t.get_trainer_startup_program()
    for ep in t.pserver_endpoints:
        t.get_pserver_program(ep)
        t.get_startup_program(ep)
    assert _snapshot(main) == before_main
    assert _snapshot(startup) == before_startup


# ---------------------------------------- the same programs as the JAX's
def _norm(v):
    """An attr value both packages can be compared by: a nested Program
    by its description, containers element by element."""
    if hasattr(v, "global_block") and hasattr(v, "blocks"):
        return ("Program", _describe(v))
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _describe(prog):
    """Every block's ops (type, slots, attrs) and vars (name, shape,
    dtype, persistable, is_data, stop_gradient), plus the distributed
    flag a pserver program carries."""
    out = []
    for blk in prog.blocks:
        ops = [(op.type, {s: list(n) for s, n in op.inputs.items()},
                {s: list(n) for s, n in op.outputs.items()},
                _norm(dict(op.attrs))) for op in blk.ops]
        vs = {n: (tuple(v.shape) if v.shape is not None else None, v.dtype,
                  bool(v.persistable), bool(getattr(v, "is_data", False)),
                  bool(v.stop_gradient)) for n, v in blk.vars.items()}
        out.append((ops, vs))
    return out, bool(getattr(prog, "_is_distributed", False))


def _ctr(pkg, distributed=True):
    models = __import__(pkg.__name__ + ".models.ctr", fromlist=["ctr"])
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = models.build("deepfm", 4, 3, 64, emb_dim=8,
                            distributed=distributed)[0]
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _sliced_mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=10, act="relu")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, size=1), y))
        pkg.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("case,min_block,sync,trainer_id", [
    ("ctr", 64, True, 0), ("ctr", 64, True, 1), ("mlp", 4, True, 0),
    ("mlp", 4, False, 0), ("net", 8192, True, 0)])
def test_programs_match_the_jax_packages(case, min_block, sync, trainer_id):
    build = {"ctr": _ctr, "mlp": _sliced_mlp, "net": _build_net}[case]
    got = {}
    for key, pkg in (("jax", jf), ("port", fluid)):
        main, startup, _ = build(pkg)
        cfg = pkg.DistributeTranspilerConfig()
        cfg.min_block_size = min_block
        t = pkg.DistributeTranspiler(cfg)
        t.transpile(trainer_id=trainer_id, program=main, pservers=EPS2,
                    trainers=2, sync_mode=sync, startup_program=startup)
        progs = {"trainer": t.get_trainer_program(),
                 "trainer_startup": t.get_trainer_startup_program(),
                 "push": t.get_trainer_push_program(),
                 "recovery": t.get_trainer_recovery_program()}
        for ep in t.pserver_endpoints:
            progs["pserver " + ep] = t.get_pserver_program(ep)
            progs["pserver_startup " + ep] = t.get_startup_program(ep)
        got[key] = ({k: _describe(p) for k, p in progs.items()},
                    _norm(t.get_rewrite_log()))
    jprogs, jlog = got["jax"]
    tprogs, tlog = got["port"]
    assert sorted(tprogs) == sorted(jprogs)
    for k in jprogs:
        assert tprogs[k] == jprogs[k], k
    assert tlog == jlog
    types = [op[0] for op in tprogs["trainer"][0][0][0]]
    if case == "ctr":
        assert "prefetch" in types and "send_sparse" in types
    if case == "mlp":
        assert "split" in types and "concat" in types
