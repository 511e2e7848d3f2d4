"""The resilience tier's lower half in the port: the watchdog, the
executor's fault sites and heartbeat stamps, and the tensor store's
crash window.

- The watchdog (resilience/watchdog.py, a copy of the JAX package's):
  a wedge against the compile grace, the oldest open operation through
  concurrent stamps, an idle heartbeat, a policy that raises, and
  ``run_with_deadline``: the JAX package's cases (tests/
  test_resilience.py), each also run against the JAX package's watchdog
  with the same stamps, the two firing alike.
- The executor's sites: ``executor.dispatch`` fires before the step
  (state untouched, retryable), ``reader.next`` and ``device_put``
  surface in ``train_loop``, the heartbeat stamps each dispatch and the
  fetch wait, and a plan's dispatches are ``compiling`` until it is
  compiled (on the CPU, its first dispatch). The same fault plans give
  the same occurrences and outcomes in both packages.
- The tensor store: a crash between the complete staging file and its
  rename keeps the previous checkpoint and leaves the litter, which the
  next save from a live process removes and counts; live writers'
  staging files are spared; a raise there removes the staging file;
  ``save_persistables_async(extra_vars=...)`` carries the RNG chain.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import watchdog as jwatchdog
from paddle_tpu_torch import io, observe
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core.executor import RNG_VAR, to_numpy
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.resilience import (FaultPlan, Heartbeat, InjectedFault,
                                         Watchdog, heartbeat,
                                         run_with_deadline)
from paddle_tpu_torch.resilience import watchdog as twatchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _value(name, **labels):
    fam = observe.get_metric(name)
    return fam.labels(**labels).value if labels else fam.value


def _wait_for(pred, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# ------------------------------------------------------------- watchdog
@pytest.mark.parametrize("mod", [twatchdog, jwatchdog],
                         ids=["port", "jax"])
def test_watchdog_wedge_vs_compile_grace(mod):
    hb = mod.Heartbeat()
    fired = []
    wd = mod.Watchdog(deadline_s=0.1, poll_s=0.02, compile_grace_s=30.0,
                      on_wedge=fired.append, heartbeat=hb)
    with wd.watching():
        # a compile may outlive the steady deadline many times over
        hb.begin("executor.dispatch", compiling=True)
        time.sleep(0.4)
        assert not fired, "compile-grace stamp misjudged as a wedge"
        hb.end("executor.dispatch")
        # a steady-state dispatch stalling past the deadline IS a wedge
        hb.begin("executor.dispatch", step=5)
        assert _wait_for(lambda: fired)
        assert (fired[0].site, fired[0].step, fired[0].compiling) == (
            "executor.dispatch", 5, False)
        time.sleep(0.3)
        assert len(fired) == 1  # once per stalled op, not per poll
        hb.end("executor.dispatch")
        hb.begin("executor.dispatch", step=6)  # a new stall re-arms
        assert _wait_for(lambda: len(fired) >= 2)
    assert wd.wedges == fired


def test_port_watchdog_counts_wedges_and_disarms():
    hb = Heartbeat()
    w0 = _value("paddle_resilience_wedges_detected_total",
                site="executor.dispatch")
    fired = []
    with Watchdog(deadline_s=0.05, poll_s=0.01, on_wedge=fired.append,
                  heartbeat=hb).watching():
        assert _value("paddle_resilience_watchdog_armed") == 1
        tok = hb.begin("executor.dispatch")
        assert _wait_for(lambda: fired)
        hb.end("executor.dispatch", tok)
    assert _value("paddle_resilience_wedges_detected_total",
                  site="executor.dispatch") == w0 + len(fired)
    assert _value("paddle_resilience_watchdog_armed") == 0


@pytest.mark.parametrize("mod", [twatchdog, jwatchdog],
                         ids=["port", "jax"])
def test_watchdog_sees_oldest_open_op_through_concurrent_stamps(mod):
    hb = mod.Heartbeat()
    fired = []
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            t = hb.begin("executor.wait")
            hb.end("executor.wait", t)
            time.sleep(0.005)

    t = threading.Thread(target=churn, daemon=True)
    with mod.Watchdog(deadline_s=0.1, poll_s=0.02, on_wedge=fired.append,
                      heartbeat=hb).watching():
        tok = hb.begin("executor.dispatch", step=3)  # wedges, never ends
        t.start()
        try:
            assert _wait_for(lambda: fired), \
                "concurrent healthy stamps masked the wedged dispatch"
        finally:
            stop.set()
            t.join()
        hb.end("executor.dispatch", tok)
    assert fired[0].site == "executor.dispatch" and fired[0].step == 3


def test_watchdog_idle_heartbeat_never_fires_and_zeroes_age():
    hb = Heartbeat()
    fired = []
    t = hb.begin("executor.dispatch")
    hb.end("executor.dispatch", t)
    with Watchdog(deadline_s=0.05, poll_s=0.01, on_wedge=fired.append,
                  heartbeat=hb).watching():
        time.sleep(0.25)
        assert _value("paddle_resilience_heartbeat_age_seconds") == 0
    assert not fired


def test_watchdog_policy_exception_does_not_kill_detector():
    hb = Heartbeat()
    seen = []

    def bad_policy(event):
        seen.append(event)
        raise RuntimeError("broken policy")

    with Watchdog(deadline_s=0.05, poll_s=0.01, on_wedge=bad_policy,
                  heartbeat=hb).watching():
        hb.begin("executor.dispatch")
        assert _wait_for(lambda: seen)
        hb.end("executor.dispatch")
        hb.begin("executor.dispatch")
        assert _wait_for(lambda: len(seen) >= 2), \
            "detector thread died in the policy callback"
        hb.end("executor.dispatch")


@pytest.mark.parametrize("mod", [twatchdog, jwatchdog],
                         ids=["port", "jax"])
def test_run_with_deadline_outcomes(mod):
    ok, val, _ = mod.run_with_deadline(lambda: 42, 30.0)
    assert ok and val == 42
    ok, val, _ = mod.run_with_deadline(
        lambda: (_ for _ in ()).throw(ValueError("boom")), 30.0)
    assert not ok and isinstance(val, ValueError)
    ok, val, dt = mod.run_with_deadline(lambda: time.sleep(30), 0.3,
                                        poll_s=0.05)
    assert not ok and isinstance(val, TimeoutError) and dt < 30


def test_watchdog_snapshot_equals_the_jax_packages():
    """The same stamps give the same poller view in both heartbeats."""
    views = []
    for mod in (twatchdog, jwatchdog):
        hb = mod.Heartbeat()
        a = hb.begin("executor.dispatch", step=1, compiling=True)
        b = hb.begin("executor.wait", step=2)
        s1 = hb.snapshot()
        hb.end("executor.dispatch", a)
        s2 = hb.snapshot()
        hb.end("executor.wait", b)
        s3 = hb.snapshot()
        views.append([{k: v for k, v in s.items() if k != "age_s"}
                      for s in (s1, s2, s3)])
    assert views[0] == views[1]
    assert views[0][0]["compiling"] and views[0][2]["phase"] == "idle"


# ------------------------------------------------- fault-site integration
def _build(pkg=pt, seed=42, dropout=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        h = pkg.layers.fc(x, 16, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=0.3)
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    main.random_seed = startup.random_seed = seed
    return main, startup, loss


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(16, 8).astype("float32"),
             "y": rs.randn(16, 1).astype("float32")} for _ in range(n)]


def _params(scope, main):
    return {v.name: to_numpy(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def test_executor_dispatch_fault_site_fires_and_state_survives():
    main, startup, loss = _build()
    scope = Scope()
    exe = pt.Executor(pt.CPUPlace())
    batches = _batches(3)
    exe.run(startup, scope=scope)
    exe.run(main, feed=batches[0], fetch_list=[loss], scope=scope)
    snap = _params(scope, main)
    with FaultPlan().arm("executor.dispatch", steps=(1,)):
        with pytest.raises(InjectedFault):
            exe.run(main, feed=batches[1], fetch_list=[loss], scope=scope)
    # the fault fired BEFORE the step: the scope is untouched
    after = _params(scope, main)
    for n in snap:
        assert np.array_equal(snap[n], after[n]), n
    out = exe.run(main, feed=batches[2], fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()


def _fault_outcome(pkg, loop, plan_args):
    """Which occurrence of a site raised in ``loop`` under one plan, and
    how many times the site was passed: (raised, occurrences)."""
    main, startup, loss = _build(pkg)
    place = pkg.CPUPlace()
    exe, scope = pkg.Executor(place), pkg.Scope()
    exe.run(startup, scope=scope)
    faults = jfaults if pkg is jf else pt.resilience.faults
    plan = faults.FaultPlan().arm(*plan_args[:1], **plan_args[1])
    raised = False
    with plan:
        try:
            loop(exe, main, loss, scope)
        except faults.InjectedFault:
            raised = True
    return raised, plan.occurrences(plan_args[0])


@pytest.mark.parametrize("site", ["reader.next", "device_put"])
def test_reader_and_device_put_fault_sites_surface_in_train_loop(site):
    def loop(exe, main, loss, scope):
        exe.train_loop(main, lambda: iter(_batches(4)), fetch_list=[loss],
                       scope=scope)

    got = _fault_outcome(pt, loop, (site, dict(steps=(2,))))
    want = _fault_outcome(jf, loop, (site, dict(steps=(2,))))
    assert got == want and got[0], (got, want)


def test_dispatch_site_occurrences_equal_the_jax_packages():
    """run, run_repeated and train_loop pass ``executor.dispatch`` and
    ``device_put`` as often as the JAX package's executor does."""
    def loop(exe, main, loss, scope):
        b = _batches(3)
        exe.run(main, feed=b[0], fetch_list=[loss], scope=scope)
        exe.run_repeated(main, feed=b[1], fetch_list=[loss], scope=scope,
                         steps=3)
        exe.train_loop(main, lambda: iter(b), fetch_list=[loss],
                       scope=scope)

    for site in ("executor.dispatch", "device_put"):
        args = (site, dict(steps=(99,)))
        assert _fault_outcome(pt, loop, args) == \
            _fault_outcome(jf, loop, args), site


def test_executor_heartbeat_stamps_dispatch_and_fetch_wait():
    main, startup, loss = _build()
    scope = Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    seq0 = heartbeat().snapshot()["seq"]
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    snap = heartbeat().snapshot()
    # begin/end around the dispatch AND around the fetch's copy to numpy
    assert snap["seq"] >= seq0 + 4
    assert snap["phase"] == Heartbeat.IDLE
    assert snap["site"] == "executor.wait"


class _Recording(Heartbeat):
    __slots__ = ("log",)

    def __init__(self):
        super().__init__()
        self.log = []

    def begin(self, site, step=None, compiling=False):
        self.log.append((site, step, compiling))
        return super().begin(site, step, compiling)


def test_dispatch_is_compiling_until_the_plan_is_compiled(monkeypatch):
    """On the CPU a plan's first dispatch per signature is its compile;
    later ones are judged against the steady deadline. The pipelined
    loop's handles stamp their waits with their step."""
    hb = _Recording()
    monkeypatch.setattr(texecutor, "heartbeat", lambda: hb)
    main, startup, loss = _build()
    scope = Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    b = _batches(4)
    exe.run(main, feed=b[0], fetch_list=[loss], scope=scope)
    exe.run(main, feed=b[1], fetch_list=[loss], scope=scope)
    exe.run_repeated(main, feed=b[2], fetch_list=[loss], scope=scope,
                     steps=2)
    exe.run_repeated(main, feed=b[3], fetch_list=[loss], scope=scope,
                     steps=2)
    exe.train_loop(main, lambda: iter(b[:2]), fetch_list=[loss],
                   scope=scope)
    dispatch = [c for s, _, c in hb.log if s == "executor.dispatch"]
    # startup, run x2, run_repeated x2 (a new signature), 2 loop steps
    assert dispatch == [True, True, False, True, False, False, False]
    waits = [st for s, st, _ in hb.log if s == "executor.wait"]
    assert waits[-2:] == [0, 1]


# ------------------------------------------------- the tensor store
def test_crash_between_tmp_write_and_rename_keeps_previous(tmp_path):
    """SIGKILL the writer between the complete staging file and the
    rename: the previous checkpoint stays loadable, the staging file is
    left behind, and the next save_persistables_async to that path from
    a live process removes it and counts it."""
    target = str(tmp_path / "ck")
    code = (
        "import numpy as np\n"
        "from paddle_tpu_torch.native import tensor_store as ts\n"
        "ts.save_tensors(%r, {'w': np.arange(4, dtype='float32')})\n"
        "ts.save_tensors(%r, {'w': np.zeros(4, dtype='float32')})\n"
        "raise SystemExit('crash fault did not fire')\n" % (target, target))
    env = dict(os.environ, PADDLE_TPU_FAULT_PLAN="checkpoint.write@2:crash",
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-500:])

    from paddle_tpu_torch.native.tensor_store import load_tensors

    assert np.array_equal(load_tensors(target)["w"],
                          np.arange(4, dtype="float32"))
    litter = [p for p in os.listdir(tmp_path) if ".tmp." in p]
    assert len(litter) == 1, litter

    o0 = _value("paddle_resilience_checkpoint_orphans_cleaned_total")
    main, startup, _ = _build()
    scope = Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    io.save_persistables_async(exe, str(tmp_path), main, scope=scope,
                               filename="ck").wait()
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []
    assert _value(
        "paddle_resilience_checkpoint_orphans_cleaned_total") == o0 + 1
    data = load_tensors(target)
    assert "w" not in data and len(data) > 0


def test_raise_at_checkpoint_write_keeps_previous_and_no_staging(tmp_path):
    from paddle_tpu_torch.native.tensor_store import (load_tensors,
                                                      save_tensors)

    target = str(tmp_path / "ck")
    save_tensors(target, {"w": np.arange(3, dtype="float32")})
    with FaultPlan().arm("checkpoint.write", steps=(1,)):
        with pytest.raises(InjectedFault):
            save_tensors(target, {"w": np.zeros(3, dtype="float32")})
    assert np.array_equal(load_tensors(target)["w"],
                          np.arange(3, dtype="float32"))
    assert os.listdir(tmp_path) == ["ck"]


def test_orphan_cleanup_spares_live_writers(tmp_path):
    from paddle_tpu_torch.native.tensor_store import save_tensors

    target = str(tmp_path / "ck")
    live = "%s.tmp.%d.999" % (target, os.getpid())
    open(live, "w").write("staged-by-a-live-writer")
    other = "%s.tmp.1.3" % target  # pid 1 is always alive
    open(other, "w").write("staged-by-another-live-writer")
    save_tensors(target, {"w": np.ones(2, dtype="float32")})
    assert os.path.exists(live) and os.path.exists(other)


def test_save_persistables_async_extra_vars_roundtrip(tmp_path):
    """The RNG chain rides the checkpoint via extra_vars (as the
    generator's state); names absent from the scope are skipped."""
    main, startup, loss = _build(dropout=True)
    scope = Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    assert scope.find_var(RNG_VAR) is not None
    io.save_persistables_async(
        exe, str(tmp_path / "ck"), main, scope=scope,
        extra_vars=(RNG_VAR, "no_such_var")).wait()
    from paddle_tpu_torch.native.tensor_store import load_tensors

    data = load_tensors(str(tmp_path / "ck" / "__model_combined__"))
    assert RNG_VAR in data and "no_such_var" not in data
    assert np.array_equal(data[RNG_VAR],
                          scope.find_var(RNG_VAR).get_state().numpy())
