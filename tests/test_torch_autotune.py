"""The port's unified autotuner (kernels/autotune.py) on the CPU: the
ports of tests/test_autotune.py's tests, and the window axis against the
JAX package's under one deterministic seed.

Every test tunes in its own ``tmp_path`` cache directory (one per
package where both tune, so neither reads the other's winners) after
``tune.reset()``, under ``PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC`` (a
stable hash in place of each timing), and builds its programs under
``unique_name.guard()``: the window's signature fingerprints the
program, var names included, so a program named by whatever ran before
in the process would hash to another winner (the JAX package's
``test_window_axis_prunes_and_reports`` builds without the guard, the
file-order dependence ROADMAP C records).

* keep_count: half the grid by default (floor 1), PADDLE_TPU_AUTOTUNE_KEEP
  checked;
* prune_candidates ranks a modeled grid deterministically (labels read
  ``cuda:``) and measures everything on an unmodeled candidate, the
  flash kernel's one configuration ``()`` among them, or with the cost
  model off;
* the kernel axis on attention: the flash kernel against the composed
  attention, nothing pruned (a grid of one), counted, persisted in the
  port's grammar;
* the window axis prunes and picks the JAX package's K;
* PADDLE_TPU_COST_MODEL=0 measures everything and moves no
  paddle_cost_* family;
* the quantize outlook prices the int8 toggle only when the pass is
  armed; autotune_program reports every axis, attention included.
"""

import os

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observe
from paddle_tpu_torch.core import window_tune as wt
from paddle_tpu_torch.core.passes.quantize_pass import (
    quantizable_weight_names)
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.kernels import tune
from paddle_tpu_torch.kernels.autotune import (autotune_kernel,
                                               autotune_program,
                                               autotune_window, keep_count,
                                               predicted_candidate_seconds,
                                               prune_candidates,
                                               quantize_outlook)
from paddle_tpu_torch.kernels.registry import get_kernel

SEED = "1"
_ENV = ("PADDLE_TPU_KERNELS", "PADDLE_TPU_KERNEL_TUNE",
        "PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", "PADDLE_TPU_COST_MODEL",
        "PADDLE_TPU_AUTOTUNE_KEEP", "PADDLE_TPU_WINDOW_CANDIDATES",
        "PADDLE_TPU_OPTIMIZE_QUANT", "PADDLE_TPU_DEVICE_HBM_BYTES")
# a blocked row config's candidates (the tuner models them; the port's
# kernels take their launch config from the built kernel)
ROW_GRID = [(8,), (64,), (256,), (512,), (1000,), (1024,)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", str(tmp_path / "kc"))
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    # pin the device: deterministic ranking, no probe ever runs
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "100")
    monkeypatch.setenv("PADDLE_TPU_PEAK_GBPS", "1000")
    monkeypatch.setenv("PADDLE_TPU_OP_OVERHEAD_US", "1")
    monkeypatch.setenv("PADDLE_TPU_CALL_OVERHEAD_US", "100")
    tune.reset()
    yield
    tune.reset()


def _value(name, **labels):
    for s in observe.snapshot()["metrics"][name]["samples"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0.0


def _cost_family_totals():
    return (sum(_value("paddle_cost_programs_total", site=s)
                for s in ("api", "cli", "bench", "autotune")),
            _value("paddle_cost_seconds"),
            _value("paddle_cost_unruled_ops_total"))


def _fc_train(pkg, hidden=8):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        h = pkg.layers.fc(x, hidden, act="relu")
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _feed(batch=16):
    rs = np.random.RandomState(0)
    return {"x": rs.randn(batch, 4).astype("float32"),
            "y": rs.randn(batch, 1).astype("float32")}


def _port_run(fn, hidden=8):
    """``fn(exe, main, feed, loss, scope)`` on a started port program."""
    main, startup, loss = _fc_train(fluid, hidden)
    scope = Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return fn(exe, main, _feed(), loss, scope)


# ------------------------------------------------------------ keep_count
def test_keep_count_default_and_env(monkeypatch):
    assert keep_count(6) == 3
    assert keep_count(5) == 2
    assert keep_count(1) == 1
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_KEEP", "1")
    assert keep_count(6) == 1
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_KEEP", "99")
    assert keep_count(6) == 6
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_KEEP", "0")
    with pytest.raises(ValueError, match=">= 1"):
        keep_count(6)
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_KEEP", "many")
    with pytest.raises(ValueError, match="integer"):
        keep_count(6)


# ------------------------------------------------------------- pruning
@pytest.mark.parametrize("op,sig", [
    ("layernorm_residual", ("float32", 1024, 512)),
    ("adam_update", ("float32", 100000)),
    ("sgd_update", ("bfloat16", 4096))])
def test_prune_is_deterministic_and_partitions_the_grid(op, sig):
    survivors, pruned = prune_candidates(op, sig, candidates=ROW_GRID)
    assert len(survivors) == len(ROW_GRID) // 2
    assert {c for c in survivors} | {tuple(p["cfg"]) for p in pruned} \
        == set(ROW_GRID)
    for p in pruned:
        assert p["label"].startswith("cuda:")
        assert p["predicted_seconds"] > 0
    worst_kept = max(predicted_candidate_seconds(op, sig, c)
                     for c in survivors)
    assert all(p["predicted_seconds"] >= worst_kept - 1e-12 for p in pruned)
    again, _ = prune_candidates(op, sig, candidates=ROW_GRID)
    assert again == survivors


def test_unmodeled_candidate_degrades_to_measure_everything():
    cands = [(128, 128), (999,)]  # the second has no grid model
    assert prune_candidates("attention", (512, 512), candidates=cands) \
        == (cands, [])
    assert prune_candidates("warp_drive", (1, 2),
                            candidates=[(1,), (2,)])[1] == []
    # the flash kernel's one configuration: unmodeled, and a grid of one
    assert get_kernel("attention").candidates((512, 512)) == [()]
    assert predicted_candidate_seconds("attention", (512, 512), ()) is None
    assert prune_candidates("attention", (512, 512)) == ([()], [])
    assert prune_candidates("attention", (512, 512),
                            candidates=[(), (64, 64)]) \
        == ([(), (64, 64)], [])


def test_cost_model_off_prunes_nothing(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COST_MODEL", "0")
    assert prune_candidates("layernorm_residual", ("float32", 1024, 512),
                            candidates=ROW_GRID) == (ROW_GRID, [])


# ----------------------------------------------- e2e: the kernel axis
@pytest.mark.parametrize("sig", [(512, 512), (128, 256)])
def test_attention_axis_measures_flash_against_composed(monkeypatch, sig):
    """The kernel axis on attention: the flash kernel's one configuration
    and the composed attention both measured (a grid of one prunes
    nothing), the exhaustive tune's winner, counted, persisted in the
    port's grammar and served from disk."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", SEED)
    exhaustive = tune.tune("attention", sig)
    tune.reset()
    r0 = _value("paddle_autotune_runs_total", axis="kernel")
    p0 = _value("paddle_autotune_pruned_total", axis="kernel")
    m0 = _value("paddle_autotune_measured_total", axis="kernel")
    dec = autotune_kernel("attention", sig)
    assert (dec["choice"], dec["cfg"]) == (exhaustive["choice"],
                                           exhaustive["cfg"])
    assert dec["choice"] in ("cuda", "composed") and "pruned" not in dec
    assert [t["label"] for t in dec["timings"]] == ["cuda:[]", "composed"]
    assert _value("paddle_autotune_runs_total", axis="kernel") == r0 + 1
    assert _value("paddle_autotune_pruned_total", axis="kernel") == p0
    assert _value("paddle_autotune_measured_total", axis="kernel") == m0 + 2
    tune.reset()
    served = tune.lookup("attention", sig)
    assert served["choice"] == dec["choice"] and "pruned" not in served


# ----------------------------------------------- e2e: the window axis
def _jax_window(tmp_path, exhaustive=False):
    """The JAX package's window decision for the same program and feed,
    tuned in its own cache dir."""
    import paddle_tpu as jf
    from paddle_tpu import kernels as jkernels
    from paddle_tpu.core import window_tune as jwt
    from paddle_tpu.kernels import autotune as jauto
    from paddle_tpu.kernels import tune as jtune

    old = os.environ["PADDLE_TPU_KERNEL_CACHE_DIR"]
    os.environ["PADDLE_TPU_KERNEL_CACHE_DIR"] = str(tmp_path / "jax_kc")
    jtune.reset()
    jkernels.reset_decisions()
    try:
        main, startup, loss = _fc_train(jf)
        scope = jf.Scope()
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup, scope=scope)
        if exhaustive:
            return jwt.tune_train_window(exe, main, _feed(), [loss], scope)
        return jauto.autotune_window(exe, main, _feed(), [loss], scope)
    finally:
        jtune.reset()
        jkernels.reset_decisions()
        os.environ["PADDLE_TPU_KERNEL_CACHE_DIR"] = old


def test_window_axis_prunes_and_picks_as_the_jax_package(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", SEED)
    want = _jax_window(tmp_path)
    want_all = _jax_window(tmp_path, exhaustive=True)

    def both(exe, main, feed, loss, scope):
        exhaustive = wt.tune_train_window(exe, main, feed, [loss], scope)
        tune.reset()
        p0 = _value("paddle_autotune_pruned_total", axis="window")
        m0 = _value("paddle_autotune_measured_total", axis="window")
        dec = autotune_window(exe, main, feed, [loss], scope)
        return (exhaustive, dec,
                _value("paddle_autotune_pruned_total", axis="window") - p0,
                _value("paddle_autotune_measured_total", axis="window") - m0)

    exhaustive, dec, pruned_n, measured_n = _port_run(both)
    by_label = {t["label"]: t for t in dec["timings"]}
    pruned = {t["label"] for t in dec["timings"] if t.get("pruned")}
    # the call overhead amortizes by K: the smallest K > 1 are pruned
    assert pruned == {"window:4", "window:10"}
    assert pruned == {t["label"] for t in want["timings"] if t.get("pruned")}
    for label in pruned:
        assert by_label[label]["seconds"] is None
        assert by_label[label]["predicted_seconds"] > 0
    assert by_label["composed"]["seconds"] is not None  # K = 1 measured
    assert (pruned_n, measured_n) == (2, 3)             # 1, 25, 50
    # the same winner as the JAX package's, and as the exhaustive tune's
    assert dec["cfg"] == want["cfg"] == exhaustive["cfg"] == \
        want_all["cfg"]
    assert [t["seconds"] for t in dec["timings"]] == \
        [t["seconds"] for t in want["timings"]]


def test_cost_model_off_window_degrades_with_zero_cost_movement(
        monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", SEED)
    monkeypatch.setenv("PADDLE_TPU_COST_MODEL", "0")

    def run(exe, main, feed, loss, scope):
        before = _cost_family_totals()
        p0 = _value("paddle_autotune_pruned_total", axis="window")
        dec = autotune_window(exe, main, feed, [loss], scope)
        return before, p0, dec

    before, p0, dec = _port_run(run)
    assert _cost_family_totals() == before
    assert _value("paddle_autotune_pruned_total", axis="window") == p0
    assert not any(t.get("pruned") for t in dec["timings"])
    assert all(t["seconds"] is not None for t in dec["timings"])


def test_window_tune_restores_the_scope_bitwise(monkeypatch):
    """The searches run steps; the scope they tuned in is left as it
    was, every param and the RNG chain included."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", SEED)

    def value(v):
        return v.get_state() if hasattr(v, "get_state") else v.clone()

    def run(exe, main, feed, loss, scope):
        names = sorted(n for n in scope._vars)
        before = {n: value(scope.find_var(n)) for n in names}
        autotune_program(exe, main, feed, [loss], scope)
        assert sorted(scope._vars) == names
        return all(value(scope.find_var(n)).equal(before[n])
                   for n in names)

    assert _port_run(run)


# ------------------------------------------------------- quantize axis
def test_quantize_outlook_gated_and_priced(monkeypatch):
    main, _startup, loss = _fc_train(fluid, hidden=64)
    feed = _feed()
    assert quantize_outlook(main, feed, [loss]) is None  # pass unarmed
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE_QUANT", "1")
    monkeypatch.setenv("PADDLE_TPU_COST_MODEL", "0")
    assert quantize_outlook(main, feed, [loss]) is None  # model off
    monkeypatch.delenv("PADDLE_TPU_COST_MODEL")
    out = quantize_outlook(main, feed, [loss])
    weights = quantizable_weight_names(main)
    assert out["weights"] == len(weights) > 0
    assert 0 < out["predicted_seconds_quantized"] \
        <= out["predicted_seconds"]
    assert out["predicted_speedup"] >= 1.0
    assert isinstance(out["recommended"], bool)


def test_quantize_outlook_matches_the_jax_package(monkeypatch):
    import paddle_tpu as jf
    from paddle_tpu.kernels.autotune import quantize_outlook as jax_outlook

    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE_QUANT", "1")
    tm, _, tl = _fc_train(fluid, hidden=64)
    jm, _, jl = _fc_train(jf, hidden=64)
    got = quantize_outlook(tm, _feed(), [tl])
    want = jax_outlook(jm, _feed(), [jl])
    assert got["weights"] == want["weights"]
    assert got["recommended"] == want["recommended"]
    for k in ("predicted_seconds", "predicted_seconds_quantized",
              "predicted_speedup"):
        assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k


# ------------------------------------------------------- the ONE search
def test_autotune_program_reports_every_axis(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", SEED)
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZE_QUANT", "1")

    report = _port_run(lambda exe, main, feed, loss, scope:
                       autotune_program(exe, main, feed, [loss], scope))
    assert {a["axis"] for a in report["axes"]} == {"window", "quantize"}
    window = next(a for a in report["axes"] if a["axis"] == "window")
    assert window["decision"]["choice"] in ("cuda", "composed")
    outlook = next(a for a in report["axes"] if a["axis"] == "quantize")
    assert outlook["outlook"]["weights"] > 0


def test_autotune_program_tunes_each_attention_signature(monkeypatch):
    """A 1-layer BERT at S = 16: the kernel axis tunes its one
    fused_attention signature (16, 16), flash against composed, and the
    winner is what the attention lowering then reads."""
    from paddle_tpu_torch.kernels import tuned_choice
    from paddle_tpu_torch.models import bert

    monkeypatch.setenv("PADDLE_TPU_KERNEL_TUNE_DETERMINISTIC", SEED)
    monkeypatch.setenv("PADDLE_TPU_WINDOW_CANDIDATES", "1,2")
    cfg = dict(d_model=32, d_ff=64, n_head=4, n_layer=1, vocab=50,
               type_vocab=2, max_length=16, dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, feeds = bert.build(cfg, seq_len=16, max_mask=2)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    rs = np.random.RandomState(0)
    feed = {}
    for v in main.global_block().vars.values():
        if v.is_data:
            shape = [4 if d < 0 else d for d in v.shape]
            feed[v.name] = (rs.randint(0, 2, shape).astype(v.dtype)
                            if "int" in v.dtype else
                            rs.rand(*shape).astype(v.dtype))
    scope = Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    report = autotune_program(exe, main, feed, [loss], scope)
    kernel = [a for a in report["axes"] if a["axis"] == "kernel"]
    assert [a["sig"] for a in kernel] == [[16, 16]]
    assert tuned_choice("attention", (16, 16)) == \
        kernel[0]["decision"]["choice"]
