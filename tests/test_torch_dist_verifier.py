"""The port's distributed-program static verifier
(paddle_tpu_torch/analysis/distributed.py, a copy of the JAX
package's) on Programs built and transpiled by the port: the JAX
package's tests/test_dist_verifier.py cases, each on the port's
programs.

Per-rule-group positive/negative cases, the model-zoo "every trainable
model transpiled at 2 trainers x 2 pservers verifies clean" gate (the
zoo's tiny configs built with the port's layers), the knockout corpus
(each seeded miscompile: guarded transpile clean / knockout caught by
the named rule with both-sides provenance / with the check off the job
is demonstrably broken), the pserver-role memory proof and the
observe-family accounting. The JAX file drives the last two of its
cases through tools/lint_distributed.py and the elastic tier; here the
same verdicts are counted at the ``cli`` and ``elastic`` sites by
``validate_distributed`` itself (neither the CLI nor the elastic tier
is ported).
"""

import copy
import json
import threading

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch.analysis import (DIST_RULES, ProgramVerifyError,
                                       shard_fit_report, validate_distributed,
                                       validate_transpile)
from paddle_tpu_torch.analysis.distributed import (BARRIER_OPS, WIRE_OPS,
                                                   pserver_spec_findings)


# the tiny model-zoo configs of the JAX package's tools/lint_program.py,
# built with the port's models
def _mnist():
    from paddle_tpu_torch.models import mnist

    return mnist.build("cnn")[0]


def _gpt():
    from paddle_tpu_torch.models import gpt

    cfg = dict(d_model=32, d_ff=64, n_head=2, n_layer=1, vocab=64,
               max_length=32, dropout=0.0)
    return gpt.build(cfg, seq_len=16)[0]


def _resnet():
    from paddle_tpu_torch.models import resnet

    return resnet.build(class_dim=10, image_shape=(3, 32, 32))[0]


def _transformer():
    from paddle_tpu_torch.models import transformer

    cfg = dict(d_model=32, d_ff=64, n_head=4, n_layer=2, src_vocab=100,
               trg_vocab=100, max_length=16, dropout=0.1)
    return transformer.build(cfg, seq_len=16)[0]


def _bert():
    from paddle_tpu_torch.models import bert

    cfg = dict(d_model=32, d_ff=64, n_head=4, n_layer=2, vocab=100,
               type_vocab=2, max_length=64, dropout=0.1)
    return bert.build(cfg, seq_len=16, max_mask=4)[0]


def _ctr():
    from paddle_tpu_torch.models import ctr

    return ctr.build("deepfm", vocab=1000, emb_dim=8)[0]


def _vgg():
    from paddle_tpu_torch.models import vgg

    return vgg.build(class_dim=10, image_shape=(3, 32, 32))[0]


def _se_resnext():
    from paddle_tpu_torch.models import se_resnext

    return se_resnext.build(class_dim=10, image_shape=(3, 32, 32))[0]


def _vit():
    from paddle_tpu_torch.models import vit

    cfg = dict(image_size=32, patch=8, d_model=32, d_ff=64, n_head=4,
               n_layer=2, n_class=10, dropout=0.0)
    return vit.build(cfg)[0]


def _stacked_lstm():
    from paddle_tpu_torch.models import stacked_lstm

    cfg = dict(vocab=60, emb_dim=16, hidden=16, num_layers=2,
               num_classes=2, seq_len=10)
    return stacked_lstm.build(cfg)[0]


def _machine_translation():
    from paddle_tpu_torch.models import machine_translation

    cfg = dict(src_vocab=50, trg_vocab=50, emb_dim=16, hidden=16, seq_len=8)
    return machine_translation.build(cfg)[0]


EXAMPLE_BUILDERS = {
    "mnist": _mnist, "gpt": _gpt, "resnet": _resnet,
    "transformer": _transformer, "bert": _bert, "ctr": _ctr, "vgg": _vgg,
    "se_resnext": _se_resnext, "vit": _vit, "stacked_lstm": _stacked_lstm,
    "machine_translation": _machine_translation}


def build_example(name):
    """Example ``name``'s (main, startup, loss) with an Adam step, under
    fresh programs (tools/lint_program.py's ``build_example``)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            loss = EXAMPLE_BUILDERS[name]()
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


EPS2 = "127.0.0.1:6170,127.0.0.1:6171"
EP_LIST = EPS2.split(",")


def _build_net(in_dim=8, out_dim=1):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[in_dim], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, size=out_dim)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _transpiled(trainers=2, pservers=EPS2, sync_mode=True):
    main, startup, _ = _build_net()
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=pservers,
                trainers=trainers, sync_mode=sync_mode,
                startup_program=startup)
    return t


def _rules(findings, severity="error"):
    return sorted({f.rule for f in findings if f.severity == severity})


# ----------------------------------------------------------- guarded = clean
def test_guarded_transpile_verifies_clean():
    t = _transpiled()
    assert validate_distributed(t) == []


def test_raises_like_program_validate():
    t = _transpiled()
    trainer = t.get_trainer_program()
    blk = trainer.global_block()
    blk.ops[:] = [op for op in blk.ops if op.type != "send_barrier"]
    with pytest.raises(ProgramVerifyError) as ei:
        validate_distributed(t, trainer_programs=[("trainer", trainer)])
    assert any(f.rule == "dist-barrier" for f in ei.value.findings)


def test_collective_mode_has_no_wire_contract():
    main, startup, _ = _build_net()
    cfg = fluid.DistributeTranspilerConfig()
    cfg.mode = "collective"
    t = fluid.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, pservers="", trainers=2,
                sync_mode=True, startup_program=startup)
    assert validate_distributed(t) == []


# ------------------------------------------------------- model-zoo 2x2 gate
@pytest.mark.parametrize("name", sorted(EXAMPLE_BUILDERS))
def test_model_zoo_transpiles_verify_clean(name):
    """Every trainable model-zoo program, transpiled at 2 trainers x
    2 pservers, verifies with zero error findings."""
    main, startup, _loss = build_example(name)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=EPS2, trainers=2,
                sync_mode=True, startup_program=startup)
    findings = validate_distributed(t, raise_on_error=False)
    assert _rules(findings) == [], [f.format() for f in findings]


def test_ctr_distributed_sparse_tables_verify_clean():
    """The ctr model with is_distributed embeddings exercises the
    SelectedRows rules: prefetch/send_sparse wires + table coverage."""
    from paddle_tpu_torch.models import ctr

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            loss = ctr.build("deepfm", vocab=1000, emb_dim=8,
                             distributed=True)[0]
            fluid.optimizer.SGD(0.1).minimize(loss)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=EPS2, trainers=2,
                sync_mode=True, startup_program=startup)
    findings = validate_distributed(t, raise_on_error=False)
    assert _rules(findings) == [], [f.format() for f in findings]
    # the job really exercised the sparse path
    trainer = t.get_trainer_program()
    types = [op.type for op in trainer.global_block().ops]
    assert "prefetch" in types and "send_sparse" in types
    assert t.get_rewrite_log()["tables"]


# ============================================================ knockout corpus
# Each seeded miscompile proves the triple: the guarded transpile is
# clean (test above), the knockout is caught by the NAMED rule with
# both-sides provenance, and with the check off the job is demonstrably
# broken.

def test_knockout_wire_shape_skew():
    t = _transpiled()
    trainer = t.get_trainer_program()
    skew = None
    for op in trainer.global_block().ops:
        if op.type == "recv":
            skew = op
            op.attrs["shape"] = [int(op.attrs["shape"][0]) + 7] + \
                list(op.attrs["shape"][1:])
            break
    assert skew is not None
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)], raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-wire-shape"]
    assert hits, _rules(findings)
    # both-sides provenance: trainer-side op anchored in the Finding
    # fields, pserver side named in the message
    f = hits[0]
    assert f.op_type == "recv" and f.def_site
    assert "pserver" in f.message and "listen_and_serv" in f.message

    # check off -> really broken: materializing each recv at its
    # declared shape cannot reassemble the hosted parameter
    wire = skew.attrs["var_name"]
    spec = None
    for ep in t.pserver_endpoints:
        ls = t.get_pserver_program(ep).global_block().ops[0]
        for s in ls.attrs["block_specs"]:
            if s["param_block"] == wire:
                spec = s
    landed = np.zeros(skew.attrs["shape"], dtype=np.float32)
    assert landed.shape != tuple(spec["shape"])


def test_knockout_dropped_shard():
    t = _transpiled()
    progs = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    ls = progs[EP_LIST[0]].global_block().ops[0]
    dropped = ls.attrs["block_specs"][0]
    ls.attrs["block_specs"] = ls.attrs["block_specs"][1:]
    findings = validate_distributed(t, pserver_programs=progs,
                                    raise_on_error=False)
    assert "dist-shard-gap" in _rules(findings)
    gap = [f for f in findings if f.rule == "dist-shard-gap"][0]
    assert dropped["param_block"] in gap.message

    # check off -> really broken: the hosted blocks no longer
    # reassemble the parameter (rows are missing)
    log = t.get_rewrite_log()
    split = next(s for s in log["splits"]
                 if any(b["name"] == dropped["param_block"]
                        for b in s["blocks"]))
    hosted_rows = 0
    for ep, prog in progs.items():
        for s in prog.global_block().ops[0].attrs["block_specs"]:
            if any(b["name"] == s["param_block"] for b in split["blocks"]):
                hosted_rows += int(s["shape"][0])
    assert hosted_rows < int(split["shape"][0])


def test_knockout_overlapping_shards():
    t = _transpiled()
    progs = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    src_ls = progs[EP_LIST[1]].global_block().ops[0]
    spec = copy.deepcopy(src_ls.attrs["block_specs"][0])
    dst_ls = progs[EP_LIST[0]].global_block().ops[0]
    dst_ls.attrs["block_specs"].append(spec)
    dst_blk = dst_ls.attrs["optimize_program"].global_block()
    src_blk = src_ls.attrs["optimize_program"].global_block()
    for n in (spec["param_block"], spec["grad_block"]):
        v = src_blk.vars[n]
        dst_blk.create_var(name=n, shape=v.shape, dtype=v.dtype,
                           persistable=True, stop_gradient=True)
    findings = validate_distributed(t, pserver_programs=progs,
                                    raise_on_error=False)
    assert "dist-shard-overlap" in _rules(findings)

    # check off -> really broken: two hosts each apply the update, so
    # the shard takes a double step and diverges from the single-host
    # parameter trajectory
    w = np.full(spec["shape"], 1.0, np.float32)
    g = np.full(spec["shape"], 0.5, np.float32)
    lr = 0.1
    single = w - lr * g
    double = (w - lr * g) - lr * g
    assert not np.allclose(single, double)


def test_knockout_unmatched_barrier():
    t = _transpiled()
    trainer = t.get_trainer_program()
    blk = trainer.global_block()
    blk.ops[:] = [op for op in blk.ops if op.type != "send_barrier"]
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)], raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-barrier"]
    assert hits, _rules(findings)
    assert "deadlock" in hits[0].message


def test_unmatched_barrier_really_deadlocks():
    """The dynamic half of the barrier knockout: a sync server's
    grad-drain only completes after the send_barrier; a trainer that
    never issues it leaves wait_grads() blocked forever (bounded here
    with a timeout, then released by issuing the barrier)."""
    from paddle_tpu_torch.distributed.rpc import RPCClient, RPCServer

    srv = RPCServer(port=0, num_trainers=1, sync=True)
    srv.start()
    ep = "127.0.0.1:%d" % srv.port
    done = threading.Event()

    def drain():
        srv.wait_grads()
        done.set()

    th = threading.Thread(target=drain, daemon=True)
    th.start()
    c = RPCClient(ep, trainer_id=0)
    c.connect()
    c.send_var("w@GRAD", np.ones((2, 2), np.float32))
    # no send_barrier: the cycle must NOT complete
    assert not done.wait(1.5)
    c.send_barrier()  # release so the test tears down cleanly
    assert done.wait(10)
    srv.set_var("w", np.ones((2, 2), np.float32))
    srv.serve()
    c.get_var("w")
    c.fetch_barrier()
    c.send_complete()
    c.close()
    th.join(timeout=10)
    srv.close()


def test_knockout_swapped_endpoint():
    t = _transpiled()
    trainer = t.get_trainer_program()
    for op in trainer.global_block().ops:
        if op.type == "send":
            op.attrs["endpoint"] = (EP_LIST[1]
                                    if op.attrs["endpoint"] == EP_LIST[0]
                                    else EP_LIST[0])
            break
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)], raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-wire-unresolved"]
    assert hits, _rules(findings)
    # the error names the host that actually serves the wire
    assert "hosted on" in hits[0].message


# ----------------------------------------------- rule-group unit negatives
def test_wire_dtype_mismatch_is_error():
    t = _transpiled()
    trainer = t.get_trainer_program()
    for op in trainer.global_block().ops:
        if op.type == "recv":
            op.attrs["dtype"] = "int64"
            break
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)], raise_on_error=False)
    assert "dist-wire-shape" in _rules(findings)


def test_unknown_endpoint_is_unresolved():
    t = _transpiled()
    trainer = t.get_trainer_program()
    for op in trainer.global_block().ops:
        if op.type == "send":
            op.attrs["endpoint"] = "127.0.0.1:9999"
            break
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)], raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-wire-unresolved"]
    assert hits and "no pserver program serves" in hits[0].message


def test_fanin_mismatch_is_error():
    t = _transpiled()
    progs = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    progs[EP_LIST[0]].global_block().ops[0].attrs["Fanin"] = 5
    findings = validate_distributed(t, pserver_programs=progs,
                                    raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-fanin"]
    assert hits and "never completes" in hits[0].message


def test_sync_mode_skew_is_error():
    t = _transpiled()
    progs = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    progs[EP_LIST[1]].global_block().ops[0].attrs["sync_mode"] = False
    findings = validate_distributed(t, pserver_programs=progs,
                                    raise_on_error=False)
    assert "dist-barrier" in _rules(findings)


def test_barrier_endpoint_subset_is_error():
    t = _transpiled()
    trainer = t.get_trainer_program()
    for op in trainer.global_block().ops:
        if op.type == "send_barrier":
            op.attrs["endpoints"] = [EP_LIST[0]]
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)], raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-barrier"]
    assert hits and "wait forever" in hits[0].message


def test_recv_before_send_barrier_is_ordering_error():
    t = _transpiled()
    trainer = t.get_trainer_program()
    blk = trainer.global_block()
    recv_pos = next(i for i, op in enumerate(blk.ops)
                    if op.type == "recv")
    sb_pos = next(i for i, op in enumerate(blk.ops)
                  if op.type == "send_barrier")
    op = blk.ops.pop(recv_pos)
    blk.ops.insert(sb_pos, op)  # recv now precedes the send_barrier
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)], raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-ordering"]
    assert hits and "recv-before-send deadlock" in hits[0].message


def test_opt_pairing_catches_unclaimed_optimizer_op():
    t = _transpiled()
    progs = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    ls = progs[EP_LIST[0]].global_block().ops[0]
    spec = ls.attrs["block_specs"][0]
    spec["opt_type"] = "adam"  # declared adam, op is sgd
    findings = validate_distributed(t, pserver_programs=progs,
                                    raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-opt-pairing"]
    assert hits, _rules(findings)


def test_pserver_spec_findings_standalone():
    """distributed/ps.py's PS-loop entry guard: a spec whose var is
    missing from the optimize program fails before the port binds."""
    t = _transpiled()
    prog = t.get_pserver_program(EP_LIST[0])
    ls = prog.global_block().ops[0]
    oblk = ls.attrs["optimize_program"].global_block()
    victim = ls.attrs["block_specs"][0]["param_block"]
    del oblk.vars[victim]
    findings = pserver_spec_findings(EP_LIST[0], prog)
    assert any(f.rule == "dist-opt-pairing" and f.severity == "error"
               for f in findings)


def test_ps_loop_entry_guard_raises(monkeypatch):
    """run_pserver_loop validates declared specs under
    PADDLE_TPU_VALIDATE=1 before binding the port."""
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.distributed.ps import run_pserver_loop

    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "1")

    t = _transpiled()
    prog = t.get_pserver_program(EP_LIST[0])
    ls = prog.global_block().ops[0]
    attrs = dict(ls.attrs)
    attrs["block_specs"] = list(attrs["block_specs"])
    bad = dict(attrs["block_specs"][0])
    bad["shape"] = [int(bad["shape"][0]) + 3] + list(bad["shape"][1:])
    attrs["block_specs"][0] = bad
    with pytest.raises(ProgramVerifyError):
        run_pserver_loop(attrs, Scope(), fluid.Executor(fluid.CPUPlace()))


# -------------------------------------------------------- compression rules
def test_bf16_compression_notes_grad_wires(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RPC_COMPRESS", "bf16")
    t = _transpiled()
    findings = validate_distributed(t, raise_on_error=False)
    notes = [f for f in findings if f.rule == "dist-wire-compress"]
    assert notes and notes[0].severity == "info"
    assert "bf16" in notes[0].message


def test_bf16_compression_rejects_integer_grad_wire(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RPC_COMPRESS", "bf16")
    t = _transpiled()
    trainer = t.get_trainer_program()
    progs = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    for op in trainer.global_block().ops:
        if op.type == "send":
            wire = op.attrs["var_name"]
            src = op.input("X")[0]
            trainer.global_block().vars[src].dtype = "int32"
            for prog in progs.values():
                ls = prog.global_block().ops[0]
                for s in ls.attrs["block_specs"]:
                    if s["grad_block"] == wire:
                        s["dtype"] = "int32"
                        oblk = ls.attrs["optimize_program"].global_block()
                        for n in (s["param_block"], s["grad_block"]):
                            if n in oblk.vars:
                                oblk.vars[n].dtype = "int32"
            break
    findings = validate_distributed(
        t, trainer_programs=[("trainer", trainer)],
        pserver_programs=progs, raise_on_error=False)
    hits = [f for f in findings if f.rule == "dist-wire-compress"
            and f.severity == "error"]
    assert hits and "corrupt" in hits[0].message


# ----------------------------------------------------- translation validation
def test_tv_clean_on_guarded_transpile():
    t = _transpiled()
    assert validate_transpile(t) == []


def test_tv_catches_undeclared_op_removal():
    t = _transpiled()
    trainer = t.get_trainer_program()
    blk = trainer.global_block()
    victim = next(i for i, op in enumerate(blk.ops)
                  if op.type == "square_error_cost")
    del blk.ops[victim]
    findings = validate_transpile(t, trainer_program=trainer)
    assert any(f.rule == "dist-tv" and "vanished" in f.message
               for f in findings)


def test_tv_catches_undeclared_non_dist_insertion():
    t = _transpiled()
    trainer = t.get_trainer_program()
    blk = trainer.global_block()
    from paddle_tpu_torch.core.program import Operator

    rogue = Operator(blk, "scale", {"X": ["x"]}, {"Out": ["x"]},
                     {"scale": 2.0})
    blk.ops.insert(0, rogue)
    findings = validate_transpile(t, trainer_program=trainer)
    assert any(f.rule == "dist-tv" and "appeared" in f.message
               for f in findings)


def test_tv_catches_dropped_param_writeback():
    """Removing the recv that writes a split param back means the
    trainer silently trains on frozen weights — the removed update has
    no surviving image."""
    t = _transpiled()
    trainer = t.get_trainer_program()
    blk = trainer.global_block()
    log = t.get_rewrite_log()
    pname = log["splits"][0]["param"]
    blk.ops[:] = [
        op for op in blk.ops
        if not (op.type in ("recv", "concat")
                and pname in (op.output("Out") or ()))]
    findings = validate_transpile(t, trainer_program=trainer)
    assert any(f.rule == "dist-tv" and "never written back" in f.message
               for f in findings)


# ------------------------------------------------------ pserver memory proof
def test_pserver_memory_proof_fits(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DEVICE_HBM_BYTES", "1G")
    t = _transpiled()
    findings = validate_distributed(t, raise_on_error=False)
    infos = [f for f in findings if f.rule == "dist-pserver-memory"]
    assert infos and all(f.severity == "info" for f in infos)
    assert "fits" in infos[0].message


def test_pserver_memory_proof_kway_verdict(monkeypatch):
    """A table sized past the device budget yields the recommender
    predicate verbatim: does not fit a single device, fits at K-way."""
    monkeypatch.setenv("PADDLE_TPU_DEVICE_HBM_BYTES", "16K")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[512], dtype="float32")
        y = fluid.layers.data(name="y", shape=[64], dtype="float32")
        pred = fluid.layers.fc(x, size=64)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=EPS2, trainers=2,
                sync_mode=True, startup_program=startup)
    findings = validate_distributed(t, raise_on_error=False)
    errs = [f for f in findings if f.rule == "dist-pserver-memory"
            and f.severity == "error"]
    assert errs
    assert "does not fit a single device" in errs[0].message
    assert "fits at" in errs[0].message and "-way" in errs[0].message


def test_shard_fit_report_math():
    rep = shard_fit_report([1000, 64], "float32",
                           budget=1000 * 64 * 4)  # exactly fits
    assert rep["fits_single"] and rep["min_ways"] == 1
    rep = shard_fit_report([1000, 64], "float32",
                           budget=250 * 64 * 4)  # quarter budget
    assert not rep["fits_single"] and rep["min_ways"] == 4
    rep = shard_fit_report([10, 64], "float32", budget=16)  # < one row
    assert not rep["fits_single"] and rep["min_ways"] is None
    rep = shard_fit_report([10, 64], "float32", budget=None)
    if rep["budget"] is None:  # unless env configures one
        assert rep["fits_single"] is None and rep["min_ways"] is None


# ------------------------------------------------- schema + observe families
def test_dist_rules_schema_matches_observe_families():
    from paddle_tpu_torch.observe.families import _DIST_RULES

    assert set(_DIST_RULES) == set(DIST_RULES)
    assert len(_DIST_RULES) == len(DIST_RULES)


def test_wire_op_tuples_exist_in_registry():
    from paddle_tpu_torch.core.registry import OPS

    for op_type in WIRE_OPS + BARRIER_OPS:
        assert op_type in OPS, op_type
    # listen_and_serv is deliberately NOT registered: the Executor
    # special-cases it as the PS-loop entry
    assert "listen_and_serv" not in OPS


def test_update_op_vocabulary_pinned_to_transpiler():
    from paddle_tpu_torch.analysis.distributed import _UPDATE_OP_TYPES
    from paddle_tpu_torch.distributed.transpiler import UPDATE_OP_TYPES

    assert _UPDATE_OP_TYPES == UPDATE_OP_TYPES


def test_observe_families_count_jobs_and_findings():
    from paddle_tpu_torch.observe.families import (ANALYSIS_DIST_FINDINGS,
                                                   ANALYSIS_DIST_JOBS)

    jobs0 = ANALYSIS_DIST_JOBS.labels(site="api").value
    t = _transpiled()
    validate_distributed(t)
    assert ANALYSIS_DIST_JOBS.labels(site="api").value == jobs0 + 1

    f0 = ANALYSIS_DIST_FINDINGS.labels(rule="dist-barrier").value
    trainer = t.get_trainer_program()
    blk = trainer.global_block()
    blk.ops[:] = [op for op in blk.ops if op.type != "send_barrier"]
    validate_distributed(t, trainer_programs=[("trainer", trainer)],
                         raise_on_error=False)
    assert ANALYSIS_DIST_FINDINGS.labels(rule="dist-barrier").value > f0


def test_elastic_site_hook(monkeypatch):
    """A world's verification counts at the ``elastic`` site, as the
    elastic tier's ``_validate_world`` records it."""
    from paddle_tpu_torch.observe.families import ANALYSIS_DIST_JOBS

    before = ANALYSIS_DIST_JOBS.labels(site="elastic").value
    assert validate_distributed(_transpiled(), site="elastic") == []
    assert ANALYSIS_DIST_JOBS.labels(site="elastic").value == before + 1


# ------------------------------------------------------------ CLI verdicts
def _cli_findings(name):
    """tools/lint_distributed.py's ``verify_example_distributed``: the
    example transpiled at 2 trainers x 2 pservers, verified at the
    ``cli`` site, never raising."""
    main, startup, _loss = build_example(name)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=EPS2, trainers=2,
                sync_mode=True, startup_program=startup)
    return validate_distributed(t, raise_on_error=False, site="cli")


def test_lint_distributed_cli_text():
    from paddle_tpu_torch.observe.families import ANALYSIS_DIST_JOBS

    before = ANALYSIS_DIST_JOBS.labels(site="cli").value
    findings = _cli_findings("mnist")
    assert not any(f.severity == "error" for f in findings)
    assert ANALYSIS_DIST_JOBS.labels(site="cli").value == before + 1
    for f in findings:
        assert f.format()


def test_lint_distributed_cli_json():
    doc = {"mnist": [{"rule": f.rule, "severity": f.severity,
                      "message": f.message, "op_type": f.op_type,
                      "var": f.var, "def_site": f.def_site}
                     for f in _cli_findings("mnist")]}
    assert json.loads(json.dumps(doc)) == {"mnist": []}
