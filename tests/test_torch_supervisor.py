"""``resilient_train_loop`` in the port (resilience/supervisor.py).

- The JAX package's supervisor cases (tests/test_resilience.py and
  tests/test_elastic.py's supervisor extensions) against the port, on
  the CPU: checkpoints and pruning, resuming a completed run, recovery
  by restart before the first checkpoint, ``resume=False`` through
  recovery, ``on_step`` at least once across a recovery, an exhausted
  restart budget, a fault during recovery, the manifest's atomic write
  and its dead-writer cleanup, the restart-cause counter, read-only
  ``checkpoint_every=0`` and the manifest's ``world`` section.
- ``test_supervised_run_matches_the_jax_packages``: a 2-layer BERT
  (hidden 64, S = 32, no dropout, SGD) trained by both packages' loops from
  the JAX package's post-startup state, under the same
  ``executor.dispatch`` raise and ``checkpoint_every=2``: the same
  steps, restarts and resume position, manifests equal outside paths
  and times, final params within PARITY_RTOL; each package's
  ``read_manifest`` and ``world_from_manifest`` read the other's.
- A recovery releases the replaced executor's plans, and the port's
  own per-recovery timings come back in the result.
- Marked slow, as in the JAX package: the chaos run (a wedge caught by
  the watchdog, then a crash) resumed bitwise the uninterrupted run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.distributed import membership as jmb
from paddle_tpu.resilience import supervisor as jsup
from paddle_tpu_torch import observe
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core.executor import RNG_VAR, to_numpy
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.distributed import membership as mb
from paddle_tpu_torch.resilience import (FaultPlan, InjectedFault,
                                         read_manifest,
                                         resilient_train_loop,
                                         write_manifest)

CPU = pt.CPUPlace()
# f32 through 8 SGD steps of a 2-layer BERT: the packages' products sum
# in different orders, so values drift apart by a few ulps a step
PARITY_RTOL = 1e-5
PARITY_ATOL = 1e-6


def _value(name, **labels):
    fam = observe.get_metric(name)
    return fam.labels(**labels).value if labels else fam.value


def _build(seed=42, dropout=False):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", [8], dtype="float32")
        y = pt.layers.data("y", [1], dtype="float32")
        h = pt.layers.fc(x, 16, act="relu")
        if dropout:
            h = pt.layers.dropout(h, dropout_prob=0.3)
        pred = pt.layers.fc(h, 1)
        loss = pt.layers.mean(pt.layers.square(pred - y))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(16, 8).astype("float32"),
             "y": rs.randn(16, 1).astype("float32")} for _ in range(n)]


def _params(scope, main):
    return {v.name: to_numpy(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _loop(main, startup, loss, batches, d, scope=None, **kw):
    kw.setdefault("max_restarts", 0)
    return resilient_train_loop(
        main, lambda: iter(batches), [loss],
        scope=scope if scope is not None else Scope(), checkpoint_dir=d,
        startup_program=startup, place=CPU, **kw)


# --------------------------------------------------------------- manifest
def test_manifest_write_read_atomic(tmp_path):
    d = str(tmp_path / "ck")
    assert read_manifest(d) is None
    man = {"version": 1, "latest": "step_00000002", "step": 2, "epoch": 0,
           "batch_in_epoch": 2, "completed": False, "var_names": ["w"],
           "retained": ["step_00000002"]}
    write_manifest(d, man)
    assert read_manifest(d) == man
    assert [p for p in os.listdir(d) if ".tmp" in p] == []


def test_write_manifest_cleans_dead_pid_staging(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(d)
    path = os.path.join(d, "manifest.json")
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    open("%s.tmp.%d" % (path, proc.pid), "w").write("{}")
    live = "%s.tmp.1" % path  # pid 1 is always alive
    open(live, "w").write("{}")
    write_manifest(d, {"version": 1, "latest": "step_00000001",
                       "step": 1, "epoch": 0, "batch_in_epoch": 1,
                       "completed": False, "var_names": [],
                       "retained": ["step_00000001"]})
    left = sorted(p for p in os.listdir(d) if ".tmp." in p)
    assert left == [os.path.basename(live)], left
    assert read_manifest(d)["step"] == 1


# ------------------------------------------------------------- supervisor
def test_supervisor_trains_checkpoints_and_prunes(tmp_path):
    main, startup, loss = _build()
    d = str(tmp_path / "ck")
    seen = []
    r = _loop(main, startup, loss, _batches(6), d, checkpoint_every=2,
              keep_last=2, on_step=lambda s, v: seen.append(s))
    assert r.steps == 6 and r.restarts == 0 and r.recoveries == []
    assert seen == [1, 2, 3, 4, 5, 6]
    assert np.isfinite(r.last[0]).all()
    man = read_manifest(d)
    assert man["completed"] and man["step"] == 6 and man["epoch"] == 1
    dirs = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert dirs == sorted(man["retained"]) and len(dirs) <= 2
    assert man["latest"] == "step_00000006"


def test_supervisor_resumes_completed_run_without_training(tmp_path):
    main, startup, loss = _build()
    d = str(tmp_path / "ck")
    s1 = Scope()
    r1 = _loop(main, startup, loss, _batches(4), d, scope=s1,
               checkpoint_every=2)
    p_done = _params(s1, main)
    s2, steps = Scope(), []
    r2 = _loop(main, startup, loss, _batches(4), d, scope=s2,
               checkpoint_every=2, on_step=lambda s, v: steps.append(s))
    assert r2.resumed_from == r1.steps == 4
    assert steps == []
    got = _params(s2, main)
    for n in p_done:
        assert np.array_equal(p_done[n], got[n]), n


def test_supervisor_recovers_via_restart_before_first_checkpoint(tmp_path):
    rec0 = _value("paddle_resilience_recoveries_total", kind="restart")
    main, startup, loss = _build()
    # startup is occurrence 1; fault the FIRST train step
    with FaultPlan().arm("executor.dispatch", steps=(2,)):
        r = _loop(main, startup, loss, _batches(4), str(tmp_path / "ck"),
                  checkpoint_every=2, max_restarts=1,
                  backoff_base_s=0.001, backoff_cap_s=0.01)
    assert r.steps == 4 and r.restarts == 1
    assert _value("paddle_resilience_recoveries_total",
                  kind="restart") == rec0 + 1


def test_resume_false_recovery_restarts_instead_of_stale_resume(tmp_path):
    d = str(tmp_path / "ck")
    main, startup, loss = _build()
    _loop(main, startup, loss, _batches(4), d, checkpoint_every=2)
    assert read_manifest(d)["step"] == 4
    rr0 = _value("paddle_resilience_recoveries_total", kind="restart")
    rs0 = _value("paddle_resilience_recoveries_total", kind="resume")
    main2, startup2, loss2 = _build()
    with FaultPlan().arm("executor.dispatch", steps=(2,)):
        r = _loop(main2, startup2, loss2, _batches(6, seed=5), d,
                  checkpoint_every=3, max_restarts=1, resume=False,
                  backoff_base_s=0.001, backoff_cap_s=0.01)
    assert r.resumed_from is None and r.steps == 6
    assert _value("paddle_resilience_recoveries_total",
                  kind="restart") == rr0 + 1
    assert _value("paddle_resilience_recoveries_total",
                  kind="resume") == rs0
    assert read_manifest(d)["step"] == 6


def test_on_step_at_least_once_across_recovery(tmp_path):
    main, startup, loss = _build()
    seen = []
    # occurrences: 1 = startup, 2.. = steps; 6 = step 5, past step 4's
    # checkpoint
    with FaultPlan().arm("executor.dispatch", steps=(6,)):
        r = _loop(main, startup, loss, _batches(8), str(tmp_path / "ck"),
                  checkpoint_every=4, max_in_flight=2, max_restarts=1,
                  backoff_base_s=0.001, backoff_cap_s=0.01,
                  on_step=lambda s, v: seen.append(s))
    assert r.steps == 8 and r.restarts == 1
    assert sorted(set(seen)) == list(range(1, 9)), seen


def test_supervisor_exhausted_restarts_reraises(tmp_path):
    main, startup, loss = _build()
    with FaultPlan().arm("executor.dispatch", every=True):
        with pytest.raises(InjectedFault):
            _loop(main, startup, loss, _batches(4), str(tmp_path / "ck"),
                  max_restarts=2, backoff_base_s=0.001,
                  backoff_cap_s=0.01)


def test_fault_during_recovery_consumes_restart_budget(tmp_path):
    i0 = _value("paddle_resilience_faults_injected_total",
                site="executor.dispatch", mode="raise")
    main, startup, loss = _build()
    with FaultPlan().arm("executor.dispatch", from_step=2):
        with pytest.raises(InjectedFault):
            _loop(main, startup, loss, _batches(4), str(tmp_path / "ck"),
                  max_restarts=2, backoff_base_s=0.001,
                  backoff_cap_s=0.01)
    # the first train step + one faulting recovery per budgeted restart
    assert _value("paddle_resilience_faults_injected_total",
                  site="executor.dispatch", mode="raise") == i0 + 3


def test_supervisor_rejects_non_callable_reader(tmp_path):
    main, startup, loss = _build()
    with pytest.raises(TypeError, match="zero-arg callable"):
        resilient_train_loop(main, iter(_batches(2)), [loss],
                             checkpoint_dir=str(tmp_path / "ck"),
                             place=CPU)


def test_recovery_releases_the_replaced_executor(tmp_path, monkeypatch):
    """Each recovery frees the old executor's plans before the fresh one
    runs (on the card: its CUDA graphs and their pool), and the result
    carries the recovery's seconds by part."""
    released = []
    orig = texecutor.Executor.release_plans

    def spy(self):
        released.append((id(self), len(self._cache)))
        orig(self)
        assert not self._cache and self._pool is None

    monkeypatch.setattr(texecutor.Executor, "release_plans", spy)
    main, startup, loss = _build()
    exe = pt.Executor(CPU)
    with FaultPlan().arm("executor.dispatch", steps=(4, 7)):
        r = resilient_train_loop(
            main, lambda: iter(_batches(6)), [loss], scope=Scope(),
            checkpoint_dir=str(tmp_path / "ck"), startup_program=startup,
            executor=exe, checkpoint_every=2, max_restarts=2,
            backoff_base_s=0.001, backoff_cap_s=0.01)
    assert r.steps == 6 and r.restarts == 2
    assert len(released) == 2 and released[0][0] == id(exe)
    assert all(n >= 1 for _, n in released)
    assert [p["cause"] for p in r.recoveries] == ["InjectedFault"] * 2
    for p in r.recoveries:
        assert set(p) == {"cause", "backoff_s", "executor_s", "restore_s",
                          "first_dispatch_s", "second_dispatch_s"}, p
        assert all(p[k] >= 0 for k in p if k != "cause")


# ---------------------------------------------- the elastic extensions
def _build_sgd(seed=7):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", [4], dtype="float32")
        y = pt.layers.data("y", [1], dtype="float32")
        pred = pt.layers.fc(x, 1)
        loss = pt.layers.mean(pt.layers.square(pred - y))
        pt.optimizer.SGD(0.1).minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def _batches_sgd(n):
    rng = np.random.RandomState(0)
    return [{"x": rng.randn(8, 4).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)} for _ in range(n)]


def test_restart_cause_counter(tmp_path):
    c0 = _value("paddle_resilience_restarts_total", cause="InjectedFault")
    o0 = _value("paddle_resilience_restarts_total", cause="other")
    main, startup, loss = _build_sgd()
    with FaultPlan().arm("executor.dispatch", steps=(3,)):
        r = _loop(main, startup, loss, _batches_sgd(4),
                  str(tmp_path / "ck"), checkpoint_every=2, max_restarts=1,
                  backoff_base_s=0.001, backoff_cap_s=0.01)
    assert r.steps == 4 and r.restarts == 1
    assert _value("paddle_resilience_restarts_total",
                  cause="InjectedFault") == c0 + 1
    assert _value("paddle_resilience_restarts_total", cause="other") == o0

    class WeirdFault(Exception):
        pass

    def explode(step, values):
        raise WeirdFault("nope")

    with pytest.raises(WeirdFault):
        _loop(main, startup, loss, _batches_sgd(2), str(tmp_path / "ck2"),
              checkpoint_every=2, retryable=(WeirdFault,), on_step=explode)
    assert _value("paddle_resilience_restarts_total",
                  cause="other") == o0 + 1


def test_checkpoint_every_zero_is_read_only(tmp_path):
    main, startup, loss = _build_sgd()
    d = str(tmp_path / "ck")
    _loop(main, startup, loss, _batches_sgd(4), d, checkpoint_every=2)
    man_before = read_manifest(d)
    assert man_before["completed"]
    d2 = str(tmp_path / "ck_ro")
    r = _loop(main, startup, loss, _batches_sgd(4), d2, checkpoint_every=0)
    assert r.steps == 4
    assert read_manifest(d2) is None and not os.path.exists(d2)
    r3 = _loop(main, startup, loss, _batches_sgd(4), d, checkpoint_every=0)
    assert r3.resumed_from == 4
    assert read_manifest(d) == man_before
    with pytest.raises(ValueError, match="checkpoint_every"):
        resilient_train_loop(main, lambda: iter(_batches_sgd(1)), [loss],
                             checkpoint_dir=d, checkpoint_every=-1,
                             place=CPU)


def test_manifest_extra_world_section(tmp_path):
    main, startup, loss = _build_sgd()
    d = str(tmp_path / "ck")
    calls = []

    def extra(step, epoch, batch):
        calls.append((step, epoch, batch))
        return {"world": mb.make_world(2, [0, 1],
                                       cursors={0: batch, 1: batch},
                                       epoch=epoch)}

    _loop(main, startup, loss, _batches_sgd(4), d, checkpoint_every=2,
          manifest_extra=extra)
    man = read_manifest(d)
    assert calls and man["world"]["num_shards"] == 2
    world, fb = mb.world_from_manifest(man)
    assert fb is None and world["trainers"] == [0, 1]
    with pytest.raises(ValueError, match="reserved"):
        _loop(main, startup, loss, _batches_sgd(2), str(tmp_path / "ck2"),
              checkpoint_every=1, manifest_extra={"step": 999},
              resume=False)


# ------------------------------------------- the two packages' loops
BERT_CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=100,
                type_vocab=2, max_length=32, dropout=0.0)
S, B, M = 32, 4, 4


def _bert(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, _ = pkg.models.bert.build(BERT_CFG, seq_len=S, max_mask=M)
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def _bert_batches(n):
    rs = np.random.RandomState(3)
    out = []
    for _ in range(n):
        pos = np.stack([rs.choice(S, M, replace=False) + i * S
                        for i in range(B)]).astype("int64")
        out.append({
            "src_ids": rs.randint(0, BERT_CFG["vocab"], (B, S)).astype(
                "int64"),
            "sent_ids": rs.randint(0, 2, (B, S)).astype("int64"),
            "input_mask": np.ones((B, S), "float32"),
            "mask_pos": pos,
            "mask_label": rs.randint(0, BERT_CFG["vocab"], (B, M)).astype(
                "int64"),
            "mask_weight": np.ones((B, M), "float32")})
    return out


def _world(step, epoch, batch):
    return {"world": mb.make_world(3, [0, 2], cursors={0: batch, 1: batch,
                                                       2: batch},
                                   epoch=epoch)}


def test_supervised_run_matches_the_jax_packages(tmp_path, monkeypatch):
    import paddle_tpu.models.bert  # noqa: F401
    import paddle_tpu_torch.models.bert  # noqa: F401

    # fused_attention at S = 32 takes the composed route in both packages
    # (the JAX package's Pallas kernel would run in interpret mode)
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "1024")
    # prepare-time verification is not what this test holds (both
    # packages' own tests cover it); it would double the prepare time
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "0")
    batches = _bert_batches(8)
    plan_text = "executor.dispatch@5:raise"
    jmain, jstart, jloss = _bert(jf)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    jd = str(tmp_path / "jax")
    with jf.resilience.FaultPlan.parse(plan_text):
        jr = jsup.resilient_train_loop(
            jmain, lambda: iter(batches), [jloss], scope=jscope,
            checkpoint_dir=jd, place=jf.CPUPlace(), checkpoint_every=2,
            keep_last=2, max_restarts=1, backoff_base_s=0.001,
            backoff_cap_s=0.01, manifest_extra=_world)

    tmain, _, tloss = _bert(pt)
    tscope = Scope()
    for n, t in params_from_jax(state, tmain, CPU.torch_device()).items():
        tscope.set_var(n, t)
    td = str(tmp_path / "port")
    with FaultPlan.parse(plan_text):
        tr = resilient_train_loop(
            tmain, lambda: iter(batches), [tloss], scope=tscope,
            checkpoint_dir=td, place=CPU, checkpoint_every=2, keep_last=2,
            max_restarts=1, backoff_base_s=0.001, backoff_cap_s=0.01,
            manifest_extra=_world)

    assert (tr.steps, tr.restarts, tr.resumed_from) == \
        (jr.steps, jr.restarts, jr.resumed_from) == (8, 1, None)
    assert tr.recoveries and tr.recoveries[0]["cause"] == "InjectedFault"
    np.testing.assert_allclose(tr.last[0], jr.last[0], rtol=PARITY_RTOL)
    # manifests equal outside times; each package reads the other's
    mans = {}
    for who, d in (("jax", jd), ("port", td)):
        for reader_pkg, read in (("jax", jsup.read_manifest),
                                 ("port", read_manifest)):
            m = dict(read(d))
            assert m.pop("unix_time") > 0
            mans[(who, reader_pkg)] = m
    assert mans[("jax", "port")] == mans[("jax", "jax")] == \
        mans[("port", "port")] == mans[("port", "jax")]
    man = mans[("port", "port")]
    assert man["completed"] and man["step"] == 8
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for who, d in (("jax", jd), ("port", td)):
        m = read_manifest(d)
        assert jmb.world_from_manifest(jsup.read_manifest(d)) == \
            mb.world_from_manifest(m) == (_world(0, 1, 0)["world"], None)
    # the final params within the stated tolerance
    for v in tmain.list_vars():
        if not v.persistable:
            continue
        a = np.asarray(jscope.find_var(v.name))
        b = to_numpy(tscope.find_var(v.name))
        assert a.shape == b.shape, v.name
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL, err_msg=v.name)


# --------------------------------------------------- the slow chaos proof
@pytest.mark.slow
def test_chaos_wedge_and_crash_resume_bitwise_identical(tmp_path):
    """A seeded plan wedges one dispatch (caught by the watchdog within
    its deadline: 0.8 s against 0.2 s) and crashes a later one; the
    supervisor resumes from the manifest both times and the final params
    and RNG chain are bitwise the fault-free run's."""
    steps, every = 12, 4
    batches = _batches(steps, seed=1)
    main, startup, loss = _build(dropout=True)
    s1 = Scope()
    r1 = _loop(main, startup, loss, batches, str(tmp_path / "a"),
               scope=s1, checkpoint_every=every)
    p0 = _params(s1, main)
    assert r1.steps == steps and r1.restarts == 0

    main2, startup2, loss2 = _build(dropout=True)
    s2 = Scope()
    d = str(tmp_path / "b")
    i0 = _value("paddle_resilience_faults_injected_total",
                site="executor.dispatch", mode="wedge")
    r0 = _value("paddle_resilience_recoveries_total", kind="resume")
    wedges = []
    plan = FaultPlan.parse(
        "executor.dispatch@7:wedge=0.8;executor.dispatch@11:raise")
    with plan:
        r2 = _loop(main2, startup2, loss2, batches, d, scope=s2,
                   checkpoint_every=every, max_restarts=3,
                   watchdog_deadline_s=0.2, on_wedge=wedges.append,
                   backoff_base_s=0.01, backoff_cap_s=0.05, backoff_seed=0)
    p1 = _params(s2, main2)
    assert wedges and wedges[0].site == "executor.dispatch"
    assert not wedges[0].compiling and r2.wedges == len(wedges)
    assert r2.steps == steps and r2.restarts == 2
    assert _value("paddle_resilience_faults_injected_total",
                  site="executor.dispatch", mode="wedge") == i0 + 1
    assert _value("paddle_resilience_recoveries_total",
                  kind="resume") == r0 + 2
    man = read_manifest(d)
    assert man["completed"] and man["step"] == steps
    assert RNG_VAR in man["var_names"]
    assert sorted(p0) == sorted(p1)
    for n in p0:
        assert p0[n].dtype == p1[n].dtype and np.array_equal(p0[n], p1[n])
    assert np.array_equal(s1.find_var(RNG_VAR).get_state().numpy(),
                          s2.find_var(RNG_VAR).get_state().numpy())
