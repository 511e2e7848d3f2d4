"""The port's profiler (paddle_tpu_torch/profiler.py) against the JAX
package's, and the repair of C7: ``observe.export_chrome_trace`` imports
the profiler to merge its host timeline, and raised ImportError while
the port had none.

Host events are the JAX package's (``RecordEvent`` on a
``time.perf_counter`` timeline, ``executor_run`` around each step); the
device trace is ``torch.profiler``'s where the JAX package starts
``jax.profiler``'s, written as chrome JSON into ``trace_dir``.
"""

import json
import os

import numpy as np

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu import profiler as jprof
from paddle_tpu_torch import observe, profiler


def _tiny(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4])
        loss = pkg.layers.reduce_sum(pkg.layers.fc(x, 3))
    place = pkg.CPUPlace()
    exe, scope = pkg.Executor(place), pkg.Scope()
    exe.run(startup, scope=scope)
    return exe, main, scope, loss


def _export(pkg, prof, trace_mod, path):
    exe, main, scope, loss = _tiny(pkg)
    feed = {"x": np.ones((2, 4), "float32")}
    with prof.profiler(state="CPU"):
        with prof.RecordEvent("my_marker"):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    trace_mod.export_chrome_trace(path)
    return json.load(open(path))["traceEvents"]


def test_export_chrome_trace_merges_the_profiler_timeline(tmp_path):
    """C7: the export writes the span ring and the profiler's host
    slices (a ``RecordEvent`` and the executor's step marker) in one
    trace, with the categories and names the JAX package writes."""
    from paddle_tpu.observe import trace as jtrace

    got = _export(pt, profiler, observe.trace, str(tmp_path / "port.json"))
    want = _export(jf, jprof, jtrace, str(tmp_path / "jax.json"))
    host = {e["name"] for e in got if e["cat"] == "host"}
    assert {"my_marker", "executor_run"} <= host
    assert host == {e["name"] for e in want if e["cat"] == "host"}
    assert {e["cat"] for e in got} == {e["cat"] for e in want} == \
        {"trace", "host"}
    assert "optimizer.pipeline" in {e["name"] for e in got
                                    if e["cat"] == "trace"}
    mark = [e for e in got if e["name"] == "my_marker"][0]
    step = [e for e in got if e["name"] == "executor_run"][0]
    assert mark["ts"] <= step["ts"] and \
        step["ts"] + step["dur"] <= mark["ts"] + mark["dur"]


def test_device_trace_and_event_table(tmp_path, capsys):
    """State ``All`` runs a ``torch.profiler`` session (the CPU's ops
    here) and writes its chrome trace into ``trace_dir``; the host table
    lists each event once with its call count."""
    exe, main, scope, loss = _tiny(pt)
    path = str(tmp_path / "host.json")
    with profiler.profiler(state="All", trace_dir=str(tmp_path / "dev"),
                           profile_path=path):
        assert profiler.is_profiler_enabled()
        for _ in range(3):
            exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                    fetch_list=[loss], scope=scope)
    assert not profiler.is_profiler_enabled()
    table = capsys.readouterr().out
    assert "Profiling Report" in table
    assert [ln.split()[1] for ln in table.splitlines()
            if ln.startswith("executor_run")] == ["3"]
    host = json.load(open(path))["traceEvents"]
    assert [e["name"] for e in host] == ["executor_run"] * 3
    (dev,) = os.listdir(str(tmp_path / "dev"))
    names = {e.get("name") for e in
             json.load(open(str(tmp_path / "dev" / dev)))["traceEvents"]}
    assert "executor_run" in names  # the marker on the device trace
