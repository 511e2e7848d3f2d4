"""The elastic tier's parts in the port: membership, the world functions,
the exporter, the shutdown handlers and the launcher.

- Membership (distributed/membership.py, a copy of the JAX package's):
  the join / beat / evict / rejoin / leave lifecycle on an injected
  clock, a partitioned join dropped by the ``membership.join`` fault
  site and retried, and heartbeats over the port's RPC transport.
- ``shard_assignment``, ``make_world``, ``reshard`` and
  ``world_from_manifest`` equal to the JAX package's over a seeded
  sweep of worlds (and the same fallbacks for malformed sections).
- The exporter (observe/export.py): ``/metrics``, ``/snapshot.json``
  and ``/healthz`` read from the watchdog's heartbeat (200 idle, 503
  once an open dispatch outlives the stale deadline, 200 again), the
  port-file rendezvous, and the off-switch.
- The shutdown handlers (observe/shutdown.py): SIGTERM flushes the
  sidecar and the flight recorder, stops the exporter, and the process
  still dies of SIGTERM; the install rules.
- The launcher (distributed/launch.py): the parsed arguments, the
  children's environments and the elastic hand-off equal the JAX
  launcher's.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu.distributed import membership as jmb
from paddle_tpu_torch import observe
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.distributed import membership as mb
from paddle_tpu_torch.observe.export import MetricsExporter, start_from_env
from paddle_tpu_torch.resilience import FaultPlan, heartbeat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _value(name, **labels):
    fam = observe.get_metric(name)
    return fam.labels(**labels).value if labels else fam.value


# ========================================================== membership
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_membership_join_beat_evict_rejoin_lifecycle():
    clock = _Clock()
    events = []
    view = mb.MembershipView(
        lease_s=5.0, clock=clock,
        on_event=lambda ev, tid, **info: events.append((ev, tid)))
    j0 = _value("paddle_elastic_membership_events_total", event="join")
    e0 = _value("paddle_elastic_membership_events_total", event="evict")
    assert view.heartbeat(0, step=1) == "join"
    assert view.heartbeat(1, step=1) == "join"
    assert view.heartbeat(0, step=2) is None
    assert view.active_trainers() == [0, 1]
    v1 = view.version
    clock.t += 4.0
    view.heartbeat(0, step=3)
    assert view.sweep() == []
    clock.t += 4.0
    assert view.sweep() == [1]
    assert view.active_trainers() == [0] and view.version > v1
    assert view.sweep() == [] and view.evict(1) is False
    assert view.heartbeat(1, step=9) == "rejoin"
    assert view.active_trainers() == [0, 1]
    assert view.leave(1) is True and view.leave(1) is False
    assert events == [("join", 0), ("join", 1), ("evict", 1),
                      ("rejoin", 1), ("leave", 1)]
    assert _value("paddle_elastic_membership_events_total",
                  event="join") == j0 + 2
    assert _value("paddle_elastic_membership_events_total",
                  event="evict") == e0 + 1
    snap = view.snapshot()
    assert snap["trainers"][0]["alive"] and snap["trainers"][0]["step"] == 3


def test_membership_join_partition_fault_drops_and_retries():
    view = mb.MembershipView(lease_s=5.0)
    d0 = _value("paddle_elastic_joins_dropped_total")
    with FaultPlan().arm("membership.join", steps=(1,)):
        assert view.heartbeat(7) is None
        assert view.active_trainers() == []
        assert view.heartbeat(7) == "join"
    assert view.active_trainers() == [7]
    assert _value("paddle_elastic_joins_dropped_total") == d0 + 1


def test_membership_server_transport_end_to_end():
    ms = mb.MembershipServer(lease_s=30.0)
    try:
        hb = mb.HeartbeatSender(ms.endpoint, tid=3, generation=1)
        hb.beat(0)
        hb.beat(1)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not ms.active_trainers():
            ms.poll(0.05)
        assert ms.active_trainers() == [3]
        lease = ms.view.lease(3)
        assert lease.step == 1 and lease.generation == 1
        hb.leave()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and ms.active_trainers():
            ms.poll(0.05)
        assert ms.active_trainers() == []
        hb.close()
    finally:
        ms.close()


def test_heartbeat_crash_site_counts_join_then_steps():
    """The ``trainer.heartbeat`` site fires once at join and once per
    step, so ``@s+1`` lands on step s's beat (the chaos knob)."""
    sender = mb.HeartbeatSender("127.0.0.1:1", tid=0)
    sender._send = lambda name, payload: None  # no transport
    with FaultPlan().arm("trainer.heartbeat", steps=(4,)) as plan:
        sender.beat(0)
        sender.beat(1)
        sender.beat(2)
        with pytest.raises(Exception):
            sender.beat(3)
    assert plan.occurrences("trainer.heartbeat") == 4


# ======================================================== world functions
def _sweep(seed=0, n=60):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        num_shards = int(rs.randint(1, 9))
        tids = sorted(set(int(t) for t in rs.randint(0, 12,
                                                     rs.randint(1, 6))))
        cursors = {s: int(rs.randint(0, 50)) for s in range(num_shards)
                   if rs.rand() < 0.7}
        epoch = int(rs.randint(0, 4))
        new = sorted(set(int(t) for t in rs.randint(0, 12,
                                                    rs.randint(1, 6))))
        yield num_shards, tids, cursors, epoch, new


def test_world_functions_equal_the_jax_packages():
    for num_shards, tids, cursors, epoch, new in _sweep():
        shuffled = list(reversed(tids))
        assert mb.shard_assignment(num_shards, shuffled) == \
            jmb.shard_assignment(num_shards, shuffled)
        w = mb.make_world(num_shards, tids, cursors=cursors, epoch=epoch)
        assert w == jmb.make_world(num_shards, tids, cursors=cursors,
                                   epoch=epoch)
        assert mb.reshard(w, new) == jmb.reshard(w, new)
        assert mb.reshard(mb.reshard(w, new), tids)["assignment"] == \
            w["assignment"]
        man = {"latest": "step_00000004", "step": 4, "epoch": epoch,
               "batch_in_epoch": 4, "var_names": [], "completed": False}
        for m in (None, man, dict(man, world=w)):
            assert mb.world_from_manifest(m) == jmb.world_from_manifest(m)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            mb.make_world(bad, [0])
        with pytest.raises(ValueError):
            jmb.make_world(bad, [0])
    with pytest.raises(ValueError):
        mb.shard_assignment(3, [])


def test_world_from_manifest_malformed_sections_as_the_jax_packages():
    b0 = _value("paddle_elastic_manifest_world_fallbacks_total",
                kind="malformed")
    man = {"latest": "step_00000004", "step": 4, "epoch": 1,
           "batch_in_epoch": 4, "var_names": [], "completed": False}
    bad = ("junk", 7, {"num_shards": 2},
           {"num_shards": 0, "trainers": [0], "assignment": {}},
           {"num_shards": 2, "trainers": [], "assignment": {"0": [0, 1]}},
           {"num_shards": 2, "trainers": [0], "assignment": {"0": [0]}},
           {"num_shards": 2, "trainers": [0], "assignment": {"0": ["x", 1]}},
           {"num_shards": 1, "trainers": [0], "assignment": {"0": [0]},
            "cursors": "oops"},
           {"num_shards": 1, "trainers": [0], "assignment": {"0": [0]},
            "cursors": {"0": "x"}},
           {"num_shards": 1, "trainers": [0], "assignment": {"0": [0]},
            "epoch": "later"})
    for w in bad:
        got = mb.world_from_manifest(dict(man, world=w))
        assert got == jmb.world_from_manifest(dict(man, world=w)) == \
            (None, "malformed"), w
    assert _value("paddle_elastic_manifest_world_fallbacks_total",
                  kind="malformed") == b0 + len(bad)
    world, fb = mb.world_from_manifest(man)
    assert fb == "missing" and world["cursors"] == {"0": 4}


# ============================================================ exporter
def _get(url):
    try:
        with urlopen(url) as r:
            return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


def test_exporter_endpoints_and_port_file_rendezvous(tmp_path):
    port_file = str(tmp_path / "metrics.port")
    ex = MetricsExporter(port=0, port_file=port_file, instance="t-0")
    ex.start()
    try:
        with open(port_file) as f:
            assert f.read().strip() == ex.endpoint
        code, text = _get("http://%s/metrics" % ex.endpoint)
        assert code == 200
        assert "paddle_export_listening 1" in text
        assert "paddle_resilience_restarts_total" in text
        code, body = _get("http://%s/snapshot.json" % ex.endpoint)
        js = json.loads(body)
        assert code == 200 and js["instance"] == "t-0" and "metrics" in js
        code, body = _get("http://%s/healthz" % ex.endpoint)
        hz = json.loads(body)
        assert code == 200 and hz["ok"] is True and hz["instance"] == "t-0"
        assert _get("http://%s/nope" % ex.endpoint)[0] == 404
    finally:
        ex.stop()
    assert not os.path.exists(port_file) and not ex.running


def test_healthz_reads_the_watchdog_heartbeat():
    """200 idle, 503 once the oldest open dispatch outlives the stale
    deadline (a compile is judged against the compile grace), 200 once
    it ends."""
    with MetricsExporter(port=0, stale_after_s=0.1,
                         compile_grace_s=30.0) as ex:
        url = "http://%s/healthz" % ex.endpoint
        assert _get(url)[0] == 200
        hb = heartbeat()
        tok = hb.begin("executor.dispatch", compiling=True)
        time.sleep(0.2)
        assert _get(url)[0] == 200
        hb.end("executor.dispatch", tok)
        tok = hb.begin("executor.dispatch", step=4)
        time.sleep(0.2)
        code, body = _get(url)
        assert code == 503
        assert json.loads(body)["heartbeat"]["site"] == "executor.dispatch"
        hb.end("executor.dispatch", tok)
        assert _get(url)[0] == 200


def test_exporter_off_switch(monkeypatch):
    from paddle_tpu_torch.observe.export import active_exporter

    monkeypatch.delenv("PADDLE_TPU_METRICS_PORT", raising=False)
    before = _value("paddle_export_listening")
    n_threads = threading.active_count()
    assert start_from_env() is None and active_exporter() is None
    assert threading.active_count() == n_threads
    assert _value("paddle_export_listening") == before


# ============================================================ shutdown
def test_shutdown_sigterm_dumps_everything(tmp_path):
    sidecar = str(tmp_path / "sidecar.json")
    ring = str(tmp_path / "flight.json")
    port_file = str(tmp_path / "metrics.port")
    ready = str(tmp_path / "ready")
    code = (
        "import time\n"
        "from paddle_tpu_torch.observe.shutdown import "
        "install_shutdown_handlers\n"
        "from paddle_tpu_torch.observe.export import start_from_env\n"
        "from paddle_tpu_torch.observe import trace as _tr\n"
        "from paddle_tpu_torch.observe.families import EXECUTOR_STEPS\n"
        "assert install_shutdown_handlers()\n"
        "assert start_from_env() is not None\n"
        "EXECUTOR_STEPS.inc(7)\n"
        "with _tr.trace_span('executor.dispatch'):\n"
        "    pass\n"
        "open(%r, 'w').write('up')\n"
        "time.sleep(60)\n" % ready)
    env = dict(os.environ, PADDLE_TPU_TRACE="1",
               PADDLE_TPU_METRICS_PORT="0",
               PADDLE_TPU_METRICS_PORT_FILE=port_file,
               PADDLE_TPU_TELEMETRY_SIDECAR=sidecar,
               PADDLE_TPU_FLIGHT_RECORDER_PATH=ring, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ready):
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert os.path.exists(port_file)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == -signal.SIGTERM
    with open(sidecar) as f:
        snap = json.load(f)["metrics"]

    def sample(fam, **labels):
        for s in snap[fam]["samples"]:
            if s.get("labels", {}) == labels:
                return s["value"]

    assert sample("paddle_executor_steps_total") == 7.0
    assert sample("paddle_shutdown_signals_total", signal="SIGTERM") == 1.0
    assert sample("paddle_export_listening") == 1.0
    with open(ring) as f:
        dump = json.load(f)
    assert dump["reason"] == "signal" and dump["events"]
    assert not os.path.exists(port_file)


def test_shutdown_handlers_install_rules():
    from paddle_tpu_torch.observe.shutdown import (
        install_shutdown_handlers, uninstall_shutdown_handlers)

    prev_term = signal.getsignal(signal.SIGTERM)
    assert install_shutdown_handlers()
    assert install_shutdown_handlers()
    uninstall_shutdown_handlers()
    assert signal.getsignal(signal.SIGTERM) is prev_term
    out = []
    t = threading.Thread(
        target=lambda: out.append(install_shutdown_handlers()))
    t.start()
    t.join()
    assert out == [False]
    assert signal.getsignal(signal.SIGTERM) is prev_term


# ============================================================ launcher
ARGVS = [
    ["train.py"],
    ["--nproc", "3", "--started_port", "7000", "train.py", "--lr", "0.1"],
    ["--pservers", "127.0.0.1:6170,127.0.0.1:6171", "--trainers", "2",
     "--role", "all", "train.py"],
    ["--pservers", "127.0.0.1:6170", "--role", "pserver", "--sync_mode",
     "0", "train.py", "-x"],
    ["--elastic", "--trainers", "3", "--elastic_steps", "12"],
    ["--elastic", "--elastic_builder", "mod:fn", "--elastic_workdir", "w"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_launch_parses_as_the_jax_launcher(argv):
    assert vars(tlaunch._parse_args(argv)) == vars(jlaunch._parse_args(argv))


@pytest.mark.parametrize("argv", [[], ["--elastic", "train.py"]])
def test_launch_refuses_as_the_jax_launcher(argv, capsys):
    for mod in (tlaunch, jlaunch):
        with pytest.raises(SystemExit) as e:
            mod._parse_args(argv)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "paddle_tpu_torch.distributed.launch" in err


class _Proc:
    def wait(self):
        return 0

    def terminate(self):
        pass


def _children(mod, argv, monkeypatch):
    spawned = []
    monkeypatch.setattr(mod, "_spawn", lambda script, args, env: (
        spawned.append((script, list(args), dict(env))) or _Proc()))
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        with pytest.raises(SystemExit) as e:
            mod.launch(argv)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    return e.value.code, spawned


@pytest.mark.parametrize("argv", ARGVS[:4])
def test_launch_children_env_as_the_jax_launcher(argv, monkeypatch):
    assert _children(tlaunch, argv, monkeypatch) == \
        _children(jlaunch, argv, monkeypatch)


def test_launch_elastic_hands_the_job_to_the_supervisor(monkeypatch,
                                                        tmp_path):
    import paddle_tpu.resilience.elastic as jel
    import paddle_tpu_torch.resilience.elastic as tel

    made = {}

    def fake(key):
        class Sup:
            def __init__(self, workdir, **kw):
                made[key] = (workdir, kw)

            def run(self):
                class R:
                    completed = True
                return R()
        return Sup

    monkeypatch.setattr(tel, "ElasticJobSupervisor", fake("port"))
    monkeypatch.setattr(jel, "ElasticJobSupervisor", fake("jax"))
    argv = ["--elastic", "--trainers", "2", "--elastic_steps", "6",
            "--elastic_workdir", str(tmp_path)]
    for mod in (tlaunch, jlaunch):
        with pytest.raises(SystemExit) as e:
            mod.launch(argv)
        assert e.value.code == 0
    assert made["port"] == made["jax"] == (str(tmp_path), dict(
        trainers=2, steps_per_epoch=6, builder=None))
