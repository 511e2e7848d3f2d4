"""The port's elastic job end to end on the CPU
(resilience/elastic.py, tools/torch_elastic_demo.py).

- ``test_elastic_demo_kill_one_of_two``: the demo CLI with ``--cpu``: a
  2-trainer job loses trainer 1 at step 3 by a ``trainer.heartbeat``
  crash; the supervisor evicts it, reshards from the manifest onto the
  survivor, and the job completes; the story is in the timeline, the
  elastic counters and the telemetry sidecars, every worker ran on the
  CPU, and the manifest's world is the surviving one.
- Marked slow, as in the JAX package: the chaos eviction's final dense
  params and RNG chain bitwise a fresh job's on the surviving world
  from the archived checkpoint, and a killed trainer's rejoin that
  completes the epoch with every batch owned exactly once.
"""

import io as _io
import json
import os
import shutil
import sys

import numpy as np
import pytest

from paddle_tpu_torch import observe
from paddle_tpu_torch.distributed import membership as mb
from paddle_tpu_torch.resilience import read_manifest
from paddle_tpu_torch.resilience.elastic import ElasticJobSupervisor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _value(name, **labels):
    fam = observe.get_metric(name)
    return fam.labels(**labels).value if labels else fam.value


def _read_timeline(workdir):
    with open(os.path.join(workdir, "timeline.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_elastic_demo_kill_one_of_two(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_elastic_demo
    finally:
        sys.path.pop(0)
    workdir = str(tmp_path / "job")
    e0 = _value("paddle_elastic_membership_events_total", event="evict")
    r0 = _value("paddle_elastic_reshards_total", cause="evict")
    rc = torch_elastic_demo.main([
        "--trainers", "2", "--steps", "5", "--kill", "1@3",
        "--checkpoint-every", "2", "--workdir", workdir, "--lease", "20",
        "--json", "--cpu"])
    assert rc == 0
    assert _value("paddle_elastic_membership_events_total",
                  event="evict") == e0 + 1
    assert _value("paddle_elastic_reshards_total", cause="evict") == r0 + 1
    events = [ev["event"] for ev in _read_timeline(workdir)]
    assert events.count("join") == 2
    assert "evict" in events and "reshard" in events
    assert events[-1] == "completed"
    man = read_manifest(os.path.join(workdir, "checkpoints"))
    assert man["completed"] and man["step"] == 5
    world, fb = mb.world_from_manifest(man)
    assert fb is None and world["trainers"] == [0]
    assert world["num_shards"] == 2
    buf = _io.StringIO()
    torch_elastic_demo.print_timeline(workdir, out=buf)
    text = buf.getvalue()
    assert "reshard" in text and "paddle_elastic" in text
    with open(os.path.join(workdir, "telemetry.json")) as f:
        snap = json.load(f)["metrics"]
    assert "paddle_elastic_membership_events_total" in snap
    # the workers ran on the CPU, as asked, and launched no kernel
    for name in ("gen1_pserver0.json", "gen1_trainer0.json"):
        with open(os.path.join(workdir, "telemetry", name)) as f:
            fam = json.load(f)["metrics"][
                "paddle_elastic_worker_kernel_launches"]
        assert {s["labels"]["slot"] for s in fam["samples"]} == {"host"}
        assert all(s["value"] == 0 for s in fam["samples"]), name
    with open(os.path.join(workdir, "logs", "gen1_pserver0.log")) as f:
        assert "Traceback" not in f.read()


def _final_blob(ckpt_dir):
    from paddle_tpu_torch.io import _load_blob

    man = read_manifest(ckpt_dir)
    _, data = _load_blob(os.path.join(ckpt_dir, man["latest"]), None)
    return man, data


@pytest.mark.slow
def test_chaos_eviction_bitwise_parity(tmp_path):
    """An N=3 job loses trainer 1 at step 5; the final dense params and
    the RNG chain are bitwise a fresh job's on the surviving world from
    the same (archived) checkpoint."""
    from paddle_tpu_torch.observe import trace as _tr

    e0 = _value("paddle_elastic_membership_events_total", event="evict")
    chaos_dir = str(tmp_path / "chaos")
    sup = ElasticJobSupervisor(
        chaos_dir, trainers=3, steps_per_epoch=8, checkpoint_every=2,
        lease_s=30.0, platform="cpu",
        worker_env={1: {"PADDLE_TPU_FAULT_PLAN":
                        "trainer.heartbeat@6:crash"}})
    res = sup.run(timeout_s=420.0)
    assert res.completed, (res, res.timeline)
    assert res.evictions == 1 and res.generations == 2
    assert _value("paddle_elastic_membership_events_total",
                  event="evict") == e0 + 1
    sites = {e["site"] for e in _tr.recorder().events()}
    assert "elastic.membership" in sites and "elastic.reshard" in sites
    reshard = [ev for ev in res.timeline if ev["event"] == "reshard"]
    assert len(reshard) == 1 and reshard[0]["cause"] == "evict"
    gen1 = [ev for ev in res.timeline
            if ev["event"] == "generation_start"][1]
    # generation 1 resumes from the latest finalized manifest, the one
    # archived. The port's trainer runs its wire ops inside the dispatch,
    # so the killed trainer finished the round it had dispatched (step 6)
    # before its step-5 heartbeat crashed it, and the survivors usually
    # finalize step 4's checkpoint before the teardown; the JAX
    # package's asynchronous dispatch leaves that round open (step 2)
    archived = read_manifest(os.path.join(chaos_dir, "reshard_g0"))
    assert gen1["trainers"] == [0, 2]
    assert gen1["resume_step"] == archived["step"] in (2, 4)
    assert sorted(s for sh in gen1["assignment"].values()
                  for s in sh) == [0, 1, 2]

    ref_dir = str(tmp_path / "ref")
    shutil.copytree(os.path.join(chaos_dir, "reshard_g0"),
                    os.path.join(ref_dir, "checkpoints"))
    ref = ElasticJobSupervisor(
        ref_dir, trainer_ids=[0, 2], steps_per_epoch=8,
        checkpoint_every=2, lease_s=30.0, platform="cpu")
    rres = ref.run(timeout_s=420.0)
    assert rres.completed and rres.evictions == 0

    man1, d1 = _final_blob(os.path.join(chaos_dir, "checkpoints"))
    man2, d2 = _final_blob(os.path.join(ref_dir, "checkpoints"))
    assert man1["step"] == man2["step"] == 8
    assert sorted(d1) == sorted(d2) and "@RNG_STATE@" in d1
    for n in sorted(d1):
        a, b = np.asarray(d1[n]), np.asarray(d2[n])
        assert a.dtype == b.dtype and a.shape == b.shape, n
        assert a.tobytes() == b.tobytes(), n


@pytest.mark.slow
def test_chaos_rejoin_completes_epoch_exactly_once(tmp_path):
    workdir = str(tmp_path / "job")
    steps = 10
    sup = ElasticJobSupervisor(
        workdir, trainers=3, steps_per_epoch=steps, checkpoint_every=2,
        lease_s=30.0, platform="cpu",
        worker_env={1: {"PADDLE_TPU_FAULT_PLAN":
                        "trainer.heartbeat@4:crash"}},
        rejoin={1: 5})
    res = sup.run(timeout_s=420.0)
    assert res.completed, (res, res.timeline)
    assert res.evictions == 1 and res.rejoins == 1
    assert [r["cause"] for r in res.reshards] == ["evict", "join"]
    man = read_manifest(os.path.join(workdir, "checkpoints"))
    assert man["completed"] and man["step"] == steps
    world, fb = mb.world_from_manifest(man)
    assert fb is None and world["trainers"] == [0, 1, 2]
    gens = [ev for ev in res.timeline if ev["event"] == "generation_start"]
    resumes = [g["resume_step"] for g in gens] + [steps]
    assert resumes[0] == 0 and resumes == sorted(resumes)
    for g in gens:
        assert sorted(s for sh in g["assignment"].values()
                      for s in sh) == list(range(world["num_shards"]))
    owned = []
    for lo, hi in zip(resumes, resumes[1:]):
        owned.extend(range(lo, hi))
    assert sorted(set(owned)) == list(range(steps))
    ff = 0.0
    tdir = os.path.join(workdir, "telemetry")
    for fn in os.listdir(tdir):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(tdir, fn)) as f:
            snap = json.load(f)["metrics"]
        fam = snap.get("paddle_resilience_fast_forward_batches_total")
        if fam:
            ff += sum(s.get("value", 0) for s in fam["samples"])
    assert ff > 0, "no generation ever fast-forwarded a replayed batch"
