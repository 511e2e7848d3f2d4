"""The port's roofline cost engine (analysis/cost.py, with the copied
analysis/cost_rules.py) against the JAX package's on the CPU.

* the ports of tests/test_cost.py's unit tests: rule tables, exact FLOP
  polynomials, grad scaling, unruled ops, env pins, persistence, the
  window's amortized call overhead, the three bound regimes, the
  one-call form and its site counter;
* the device model's own: the H100 peak table by dtype (bf16 for the
  ops core/amp.py casts under AMP, TF32 for the matmul family where
  torch allows it, f32 otherwise), the probes through the port's
  executor, a probe failure raising on the card and degrading on the
  CPU;
* all eleven zoo train programs (tools/lint_program.py's models, built
  by each package) price alike: ``flops_poly()`` and ``bytes_poly()``
  equal exactly and ``predicted_seconds(8)`` within 1e-12 relative,
  under a device model pinned by all four env vars;
* the autotuner's kernel workloads reproduce the bound column of
  PERF.md's kernel table (``chip_smoke.py``'s bounds) within 5% on a
  pinned H100 model.

The zoo's MEASURED gate (predicted within 4x of the measured step on >=
9/11) is ``slow`` here, as in the JAX package; ``chip_smoke.py`` phase
18 holds it on the card.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, observe
from paddle_tpu_torch.analysis import cost as cost_mod
from paddle_tpu_torch.analysis.cost import (CostAnalysis, DeviceModel,
                                            ZOO_COST_GATE_FACTOR,
                                            cost_model_enabled,
                                            predict_step_seconds)
from paddle_tpu_torch.analysis.cost_rules import (COST_RULES,
                                                  GRAD_FLOPS_FACTOR,
                                                  ZERO_COST)
from paddle_tpu_torch.core.scope import Scope

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# the four-field env pin: deterministic device, no probe, no disk
_PIN = {"PADDLE_TPU_PEAK_TFLOPS": "100",      # 1e14 FLOP/s
        "PADDLE_TPU_PEAK_GBPS": "1000",       # 1e12 B/s
        "PADDLE_TPU_OP_OVERHEAD_US": "1",     # 1e-6 s
        "PADDLE_TPU_CALL_OVERHEAD_US": "100"}  # 1e-4 s
H100 = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """No test reads or writes a device model outside its tmp dir, and
    none reuses another's memoized model."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", str(tmp_path / "kc"))
    for k in list(_PIN) + ["PADDLE_TPU_COST_MODEL"]:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(cost_mod, "_MODEL_CACHE", {})
    yield


@pytest.fixture
def pinned_device(monkeypatch):
    for k, v in _PIN.items():
        monkeypatch.setenv(k, v)
    return DeviceModel.current()


@pytest.fixture
def h100(monkeypatch):
    """The device model of an H100 without one: its name, and overhead
    probes that return fixed numbers (counted)."""
    probes = []

    def probe(kind):
        probes.append(kind)
        return 2e-6, 150e-6

    monkeypatch.setattr(DeviceModel, "_device_kind", staticmethod(
        lambda: H100))
    monkeypatch.setattr(DeviceModel, "_probe_overheads", classmethod(
        lambda cls, kind: probe(kind)))
    monkeypatch.setattr(DeviceModel, "_probe_conv", classmethod(
        lambda cls, kind: 5e12))
    return probes


def _value(name, **labels):
    for s in observe.snapshot()["metrics"][name]["samples"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0.0


def _fc_train(hidden=8, optimizer=True, data_shape=(4,)):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", list(data_shape), dtype="float32")
        h = layers.fc(x, hidden, act="relu")
        h2 = layers.fc(h, 1)
        loss = layers.mean(h2)
        if optimizer:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


# ------------------------------------------------------------ rule table
def test_rule_tables_are_disjoint_and_nonempty():
    assert set(COST_RULES) and set(ZERO_COST)
    assert not set(COST_RULES) & set(ZERO_COST)


def test_zero_cost_ops_price_to_nothing(pinned_device):
    main, _, loss = _fc_train(optimizer=False)
    ca = CostAnalysis(main, fetch_names=[loss.name])
    for c in ca.op_costs:
        if c.op_type in ZERO_COST:
            assert c.flops.at(32) == 0 and c.bytes.at(32) == 0
            assert c.ruled


def test_matmul_flops_are_exact_batch_polynomial(pinned_device):
    main, _, loss = _fc_train(hidden=16, optimizer=False,
                              data_shape=(784,))
    ca = CostAnalysis(main, fetch_names=[loss.name])
    first = [c for c in ca.op_costs if c.op_type == "mul"][0]
    for b in (1, 8, 64):
        assert first.flops.at(b) == 2 * b * 784 * 16
    assert not first.flops.is_const


def test_grad_ops_scale_base_rule_by_factor(pinned_device):
    main, _, loss = _fc_train(hidden=16, optimizer=True,
                              data_shape=(784,))
    ca = CostAnalysis(main, fetch_names=[loss.name])
    by_type = {}
    for c in ca.op_costs:
        by_type.setdefault(c.op_type, []).append(c)
    fwd = by_type["mul"][0]
    bwd = next(c for c in by_type["mul_grad"]
               if c.flops.at(8) == GRAD_FLOPS_FACTOR * fwd.flops.at(8))
    assert bwd.ruled


def test_unruled_op_contributes_bytes_only_and_is_counted(pinned_device):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [4], dtype="float32")
    gb = main.global_block()
    out = gb.create_var(name="myst_out", shape=[-1, 4], dtype="float32")
    gb.append_op(type="mystery_op", inputs={"X": [x]},
                 outputs={"Out": [out]})
    u0 = _value("paddle_cost_unruled_ops_total")
    ca = CostAnalysis(main, infer=False)
    assert "mystery_op" in ca.unruled
    assert _value("paddle_cost_unruled_ops_total") == u0 + 1
    c = next(c for c in ca.op_costs if c.op_type == "mystery_op")
    assert not c.ruled and c.flops.at(8) == 0
    assert c.bytes.at(8) == 2 * 8 * 4 * 4  # in + out, f32


# ----------------------------------------------------------- DeviceModel
def test_device_model_env_pin_all_four(pinned_device):
    dev = pinned_device
    assert dev.source == "env"
    assert dev.peak_flops == 100e12 and dev.peak_bandwidth == 1000e9
    assert dev.op_overhead == pytest.approx(1e-6)
    assert dev.call_overhead == pytest.approx(1e-4)
    # the env FLOP peak pins the conv class and every dtype too
    assert dev.conv_peak_flops == dev.peak_flops
    assert {dev.peak_for(d) for d in ("float32", "tf32", "bfloat16")} \
        == {100e12}


def test_device_kind_names_the_card_or_the_cpu():
    kind = DeviceModel._device_kind()
    if torch.cuda.is_available():
        assert kind == "cuda:" + torch.cuda.get_device_name()
    else:
        assert kind == "cpu:cpu"


def test_h100_peaks_come_from_the_table_by_dtype(h100, monkeypatch):
    dev = DeviceModel.current()
    assert dev.source == "table" and dev.kind == H100
    assert dev.peak_flops == 66.9e12 and dev.peak_bandwidth == 3.35e12
    assert dev.peak_for("tf32") == 494.7e12
    assert dev.peak_for("bfloat16") == dev.peak_for("float16") == 989.4e12
    assert dev.conv_peak_flops == 5e12  # the conv probe's, under the table
    assert (dev.op_overhead, dev.call_overhead) == (2e-6, 150e-6)
    assert h100 == [H100]  # the two overheads probed once ...
    assert DeviceModel.current() is dev
    # ... and persisted: a fresh process reads them back, no probe
    monkeypatch.setattr(cost_mod, "_MODEL_CACHE", {})
    again = DeviceModel.current()
    assert again.source == "calibrated" and h100 == [H100]
    assert again.to_dict()["dtype_peaks"] == dev.to_dict()["dtype_peaks"]
    assert again.conv_peak_flops == 5e12
    # one env field layers over the table, the peaks stay put
    monkeypatch.setenv("PADDLE_TPU_PEAK_GBPS", "500")
    dev2 = DeviceModel.current()
    assert dev2.source == "env" and dev2.peak_bandwidth == 500e9
    assert dev2.peak_for("bfloat16") == 989.4e12
    # both overheads pinned: nothing is probed
    monkeypatch.setattr(cost_mod, "_MODEL_CACHE", {})
    monkeypatch.setenv("PADDLE_TPU_KERNEL_CACHE_DIR", "0")
    monkeypatch.setenv("PADDLE_TPU_OP_OVERHEAD_US", "3")
    monkeypatch.setenv("PADDLE_TPU_CALL_OVERHEAD_US", "40")
    dev3 = DeviceModel.current()
    assert h100 == [H100] and dev3.op_overhead == pytest.approx(3e-6)
    assert dev3.peak_for("tf32") == 494.7e12


def test_compute_peak_follows_the_products_dtype(h100, monkeypatch):
    """f32 products divide by the f32 peak; with TF32 allowed the matmul
    family (grads too) by TF32's; under AMP every op core/amp.py casts
    to bf16 by bf16's; an f32 conv by the conv-class peak. predicted_mfu
    divides by the program's product peak."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    main, _, loss = _fc_train(hidden=16, data_shape=(64,))
    ca = CostAnalysis(main, fetch_names=[loss.name])
    dev = ca.device
    assert ca._compute_peak(dev, "mul") == 66.9e12
    assert ca._compute_peak(dev, "mul_grad") == 66.9e12
    assert ca._compute_peak(dev, "conv2d") == dev.conv_peak_flops
    assert ca.program_peak() == 66.9e12
    mfu32 = ca.predicted_mfu(8)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert ca._compute_peak(dev, "mul") == 494.7e12
    assert ca._compute_peak(dev, "matmul_grad") == 494.7e12
    assert ca._compute_peak(dev, "conv2d") == dev.conv_peak_flops
    assert ca._compute_peak(dev, "relu") == 66.9e12
    assert ca.program_peak() == 494.7e12
    assert ca.predicted_mfu(8) < mfu32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    main.set_amp(True)
    amp = CostAnalysis(main, fetch_names=[loss.name])
    for op in ("mul", "mul_grad", "conv2d", "elementwise_add", "relu"):
        assert amp._compute_peak(dev, op) == 989.4e12, op
    for op in ("softmax", "layer_norm", "adam", "reduce_sum"):
        assert amp._compute_peak(dev, op) == 66.9e12, op
    assert amp.program_peak() == 989.4e12


def test_device_model_malformed_env_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "fast")
    with pytest.raises(ValueError, match="PADDLE_TPU_PEAK_TFLOPS"):
        DeviceModel.current()
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "-3")
    with pytest.raises(ValueError, match="positive"):
        DeviceModel.current()


def test_device_model_persistence_round_trip(tmp_path):
    dev = DeviceModel("probe:box", 2e12, 3e11, 5e-6, 2e-4,
                      conv_peak_flops=4e11, source="calibrated",
                      dtype_peaks={"bfloat16": 8e12})
    dev.persist()
    path = tmp_path / "kc" / "device_model.json"
    assert path.exists()
    got = DeviceModel._load_calibrated("probe:box")
    assert got is not None and got.source == "calibrated"
    assert got.peak_flops == 2e12 and got.peak_bandwidth == 3e11
    assert got.op_overhead == 5e-6 and got.call_overhead == 2e-4
    assert got.conv_peak_flops == 4e11
    assert got.peak_for("bfloat16") == 8e12
    assert got.peak_for("float32") == 2e12
    DeviceModel("probe:other", 1e12, 1e11, source="calibrated").persist()
    data = json.load(open(path))
    assert set(data["models"]) == {"probe:box", "probe:other"}
    path.write_text("{nope")
    assert DeviceModel._load_calibrated("probe:box") is None
    path.write_text(json.dumps({"version": 999, "models": {}}))
    assert DeviceModel._load_calibrated("probe:box") is None


def test_cpu_calibration_probes_through_the_port(monkeypatch):
    """On the CPU the peaks are probed with torch ops and the overheads
    through the port's Executor: positive numbers, persisted, and a
    second resolution reads them back without probing."""
    monkeypatch.setattr(DeviceModel, "_device_kind",
                        staticmethod(lambda: "cpu:cpu"))
    monkeypatch.setattr(cost_mod, "_PROBE_RUNS", 2)
    dev = DeviceModel.current()
    assert dev.source == "calibrated"
    for v in (dev.peak_flops, dev.peak_bandwidth, dev.op_overhead,
              dev.call_overhead, dev.conv_peak_flops):
        assert v > 0
    assert dev.conv_peak_flops <= dev.peak_flops
    monkeypatch.setattr(cost_mod, "_MODEL_CACHE", {})
    monkeypatch.setattr(DeviceModel, "_calibrate", classmethod(
        lambda cls, kind: pytest.fail("probed twice")))
    assert DeviceModel.current().to_dict() == dev.to_dict()


def test_a_failed_probe_raises_on_the_card_and_degrades_on_the_cpu(
        monkeypatch):
    def broken(cls, kind):
        raise RuntimeError("probe broke")

    monkeypatch.setattr(DeviceModel, "_probe_peaks", classmethod(broken))
    monkeypatch.setattr(DeviceModel, "_probe_conv", classmethod(broken))
    monkeypatch.setattr(DeviceModel, "_probe_overheads", classmethod(broken))
    monkeypatch.setattr(DeviceModel, "_device_kind",
                        staticmethod(lambda: "cpu:cpu"))
    assert DeviceModel.current().source == "default"
    for kind in ("cuda:NVIDIA A100-SXM4-80GB", H100):
        monkeypatch.setattr(cost_mod, "_MODEL_CACHE", {})
        monkeypatch.setattr(DeviceModel, "_device_kind",
                            staticmethod(lambda k=kind: k))
        with pytest.raises(RuntimeError, match="probe broke"):
            DeviceModel.current()


# ------------------------------------------------------ roofline queries
def test_window_k_amortizes_exactly_the_call_overhead(pinned_device):
    main, _, loss = _fc_train()
    ca = CostAnalysis(main, fetch_names=[loss.name], device=pinned_device)
    p1 = ca.predicted_seconds(8, steps_per_call=1)
    p10 = ca.predicted_seconds(8, steps_per_call=10)
    call = pinned_device.call_overhead
    assert p1 - p10 == pytest.approx(call * (1 - 1 / 10))
    assert 0 < ca.predicted_mfu(8, steps_per_call=10) <= 1.0


def test_bound_classifies_all_three_regimes(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "1e-6")   # 1e6 FLOP/s
    monkeypatch.setenv("PADDLE_TPU_PEAK_GBPS", "1e9")
    monkeypatch.setenv("PADDLE_TPU_OP_OVERHEAD_US", "1")
    monkeypatch.setenv("PADDLE_TPU_CALL_OVERHEAD_US", "1")
    main, _, loss = _fc_train(hidden=64, optimizer=False,
                              data_shape=(784,))
    ca = CostAnalysis(main, fetch_names=[loss.name])
    mul = next(r for r in ca.table(64) if r["op_type"] == "mul")
    assert mul["bound"] == "compute"
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "1e6")
    monkeypatch.setenv("PADDLE_TPU_PEAK_GBPS", "1e-3")     # 1e6 B/s
    ca2 = CostAnalysis(main, fetch_names=[loss.name])
    mul2 = next(r for r in ca2.table(64) if r["op_type"] == "mul")
    assert mul2["bound"] == "memory"
    monkeypatch.setenv("PADDLE_TPU_PEAK_GBPS", "1e9")
    monkeypatch.setenv("PADDLE_TPU_OP_OVERHEAD_US", "1e6")
    ca3 = CostAnalysis(main, fetch_names=[loss.name])
    assert {r["bound"] for r in ca3.table(64)} == {"overhead"}


def test_predict_step_seconds_convenience_and_site_counter(pinned_device):
    main, _, loss = _fc_train()
    c0 = _value("paddle_cost_programs_total", site="api")
    secs = predict_step_seconds(main, batch_size=8, fetch_names=[loss.name])
    assert secs > 0
    assert _value("paddle_cost_programs_total", site="api") == c0 + 1


def test_analysis_package_exports_the_engine():
    from paddle_tpu_torch import analysis

    for name in ("CostAnalysis", "DeviceModel", "predict_step_seconds",
                 "register_cost_rule", "cost_model_enabled"):
        assert name in analysis.__all__ and hasattr(analysis, name)
    assert cost_model_enabled()


# ------------------------------------------- the zoo, against the JAX side
ZOO = ("bert", "ctr", "gpt", "machine_translation", "mnist", "resnet",
       "se_resnext", "stacked_lstm", "transformer", "vgg", "vit")


@pytest.mark.parametrize("name", ZOO)
def test_zoo_program_prices_as_in_the_jax_package(name, pinned_device):
    from lint_program import EXAMPLE_BUILDERS, build_example
    from torch_cost_report import EXAMPLE_BUILDERS as PORT_BUILDERS
    from torch_cost_report import build_example as port_example

    from paddle_tpu.analysis.cost import CostAnalysis as JaxCost

    assert sorted(EXAMPLE_BUILDERS) == sorted(PORT_BUILDERS) == list(ZOO)
    jm, _, jl = build_example(name)
    tm, _, tl = port_example(name)
    j = JaxCost(jm, fetch_names=[jl.name])
    t = CostAnalysis(tm, fetch_names=[tl.name])
    assert t.flops_poly().describe() == j.flops_poly().describe()
    assert t.bytes_poly().describe() == j.bytes_poly().describe()
    for b in (1, 8, 64):
        assert t.flops(b) == j.flops(b) and t.bytes_moved(b) == \
            j.bytes_moved(b)
    assert t.unruled == j.unruled
    want = j.predicted_seconds(8)
    assert abs(t.predicted_seconds(8) - want) <= 1e-12 * want
    assert abs(t.predicted_mfu(8) - j.predicted_mfu(8)) <= \
        1e-12 * j.predicted_mfu(8)


def test_cost_report_cli_prints_every_zoo_model(capsys, pinned_device):
    import torch_cost_report

    assert torch_cost_report.main(["--model", "mnist", "bert",
                                   "--batch-size", "8", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"mnist", "bert"}
    for rep in out.values():
        assert rep["predicted_seconds"] > 0 and rep["flops"] > 0
        assert rep["device"]["source"] == "env"
    assert torch_cost_report.main(["--model", "gpt", "--top", "3"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("== gpt @ batch 32") and "ms/step" in text


# ---------------------------------- the tuner's kernel model, PERF.md §6
def test_kernel_workloads_reproduce_the_bound_column(monkeypatch, h100):
    """On the H100's table model, ``autotune._kernel_workload``'s roofline
    (max of FLOPs over the f32 peak and bytes over HBM3's rate) lands
    within 5% of PERF.md's bound column for K1 at BERT-base's [8, 12,
    512, 64] (0.0962 ms, operations), K4 at [4096, 768] f32 (0.0150 ms),
    K6 (1.1110 ms) and K7 (0.4761 ms) over BERT-base's 157 params. The
    tuner's K1 count carries 10 FLOPs per score for the softmax on top
    of the two products the table's bound counts, so it reads 4% over
    the table: the table's products-only bound is the tighter one."""
    from paddle_tpu_torch.kernels import autotune
    from paddle_tpu_torch.models import bert

    dev = DeviceModel.current()
    # BERT-base MLM's trained params, as chip_smoke.py's phase 6 builds
    # them (no startup run)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = bert.build(bert.base_config(), seq_len=512, max_mask=80)
        _, pg = fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    n = sum(int(np.prod(p.shape)) for p, _ in pg)
    assert (len(pg), n) == (157, 132919866)

    def roofline(op, sig):
        flops, nbytes = autotune._kernel_workload(op, sig)
        return max(flops / dev.peak_flops, nbytes / dev.peak_bandwidth) * 1e3

    monkeypatch.setattr(autotune, "_attn_tune_dims", lambda: (8, 12, 64))
    for got, want in ((roofline("attention", (512, 512)), 0.0962),
                      (roofline("layernorm_residual", ("float32", 4096, 768)),
                       0.0150),
                      (roofline("adam_update", ("float32", n)), 1.1110),
                      (roofline("sgd_update", ("float32", n)), 0.4761)):
        assert abs(got / want - 1) <= 0.05, (got, want)


# ------------------------------------------------------- model-zoo gate
def _synth_feed(main, batch):
    feed = {}
    for v in main.global_block().vars.values():
        if not v.is_data:
            continue
        shape = [batch if (d is None or d < 0) else int(d)
                 for d in (v.shape or [])]
        dt = str(v.dtype or "float32")
        feed[v.name] = np.zeros(
            shape, dtype="int64" if "int" in dt else "float32")
    return feed


@pytest.mark.slow
def test_zoo_predicted_within_stated_factor_of_measured():
    """The port on the CPU, live-calibrated: every one of the 11 zoo
    train programs prices, and the predicted step sits within
    ZOO_COST_GATE_FACTOR of the measured warm step on >= 9/11."""
    from torch_cost_report import EXAMPLE_BUILDERS, build_example

    assert ZOO_COST_GATE_FACTOR == 4.0
    batch = 8
    ratios, ok = {}, 0
    for name in sorted(EXAMPLE_BUILDERS):
        main, startup, loss = build_example(name)
        scope = Scope()
        ca = CostAnalysis(main, fetch_names=[loss.name], scope=scope)
        pred = ca.predicted_seconds(batch)
        assert pred > 0
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        feed = _synth_feed(main, batch)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            best = min(best, time.perf_counter() - t0)
        ratios[name] = pred / best
        if 1.0 / ZOO_COST_GATE_FACTOR <= ratios[name] <= ZOO_COST_GATE_FACTOR:
            ok += 1
    assert ok >= 9, "only %d/%d within %gx: %r" % (
        ok, len(ratios), ZOO_COST_GATE_FACTOR, ratios)
