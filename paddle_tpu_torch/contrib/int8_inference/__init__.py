"""Post-training int8 calibration (offline quantization).

Reference: python/paddle/fluid/contrib/int8_inference/utility.py
(`Calibrator`: run fp32 inference over sample batches, collect per-var
activation statistics — max or KL-divergence thresholds — then emit a
calibrated int8 program). The port keeps the JAX package's workflow
and statistics (numpy arithmetic over activations fetched to the host)
and emits *fixed-scale* fake-quant/dequant ops (ops/quant_ops.py)
instead of the reference's int8 kernel rewrite; the scales are
what deployment needs (contrib/quantize/__init__.py freeze_program
documents the same design choice for QAT).

    calib = Calibrator(infer_program, scope=scope, algo="KL")
    for batch in sample_batches:
        calib.sample_data(executor, feed=batch, fetch_list=[pred])
    quant_prog = calib.generate_calibrated_program()
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.ir import Graph, PatternMatcher
from ...core.program import Parameter, Program
from ...core.scope import Scope, global_scope
from ..quantize import QUANTIZABLE_OP_TYPES, _ACT_SLOTS, _WEIGHT_SLOTS

__all__ = ["Calibrator"]


class Calibrator:
    """Collects activation ranges over sample runs, then rewrites the
    program with fixed-scale quant ops. algo: "max" (abs-max) or "KL"
    (entropy-minimizing threshold, the reference's conv default)."""

    def __init__(self, program: Program, scope: Optional[Scope] = None,
                 algo: str = "KL", bits: int = 8, bins: int = 2048,
                 quantizable_op_types=QUANTIZABLE_OP_TYPES):
        if algo not in ("max", "KL"):
            raise ValueError("algo must be 'max' or 'KL', got %r" % algo)
        self.program = program
        self.scope = scope or global_scope()
        self.algo = algo
        self.bits = bits
        self.bins = bins
        self.op_types = tuple(quantizable_op_types)
        # var name -> running stats
        self._absmax: Dict[str, float] = {}
        self._hist: Dict[str, np.ndarray] = {}
        self._hist_edge: Dict[str, float] = {}
        self._act_vars = self._find_activation_vars()
        self._scales: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------ sampling
    def _find_activation_vars(self) -> List[str]:
        block = self.program.global_block()
        names: List[str] = []
        for op in block.ops:
            if op.type not in self.op_types:
                continue
            for slot in _ACT_SLOTS.get(op.type, ()):
                for n in op.inputs.get(slot, []):
                    var = block.vars.get(n)
                    if n and not isinstance(var, Parameter) \
                            and n not in names:
                        names.append(n)
        return names

    @property
    def sampling_vars(self) -> List[str]:
        """Activation vars whose ranges are being calibrated."""
        return list(self._act_vars)

    def sample_data(self, executor, feed, fetch_list=None) -> None:
        """Run one fp32 batch through the program and fold the sampled
        activations into the running statistics (reference
        utility.py:77 sample_data)."""
        self._device = executor.device
        vals = executor.run(self.program, feed=feed,
                            fetch_list=self._act_vars, scope=self.scope)
        for name, v in zip(self._act_vars, vals):
            a = np.abs(np.asarray(v, dtype=np.float64)).ravel()
            amax = float(a.max()) if a.size else 0.0
            prev = self._absmax.get(name, 0.0)
            self._absmax[name] = max(prev, amax)
            if self.algo != "KL":
                continue
            # histogram on a fixed grid per var; re-bin when max grows
            edge = self._hist_edge.get(name)
            if edge is None or amax > edge:
                new_edge = max(amax, edge or 0.0) or 1.0
                hist = np.zeros(self.bins)
                if name in self._hist and edge:
                    old = self._hist[name]
                    idx = (np.arange(self.bins) + 0.5) * (edge / self.bins)
                    ridx = np.minimum(
                        (idx / new_edge * self.bins).astype(int),
                        self.bins - 1)
                    np.add.at(hist, ridx, old)
                self._hist[name] = hist
                self._hist_edge[name] = new_edge
                edge = new_edge
            h, _ = np.histogram(a, bins=self.bins, range=(0.0, edge))
            self._hist[name] += h
        self._scales = None  # stats changed; recompute on demand

    # ------------------------------------------------------------- scales
    def _kl_threshold(self, hist: np.ndarray, edge: float) -> float:
        """Entropy-minimizing saturation threshold — the reference's KL
        algorithm (utility.py __get_optimal_scaling_factor): histogram of
        |x|, 255 quantized bins, and candidate thresholds only over the
        top 30% of the observed range (starting_iter = 0.7 * bins for
        non-negative data), so calibration trims genuine outliers rather
        than clipping the distribution's body."""
        levels = (1 << self.bits) - 1  # 255 for int8 (num_quantized_bins)
        total = hist.sum()
        if total == 0:
            return edge
        hist = hist.astype(np.float64)
        nonzero = (hist > 0).astype(np.float64)
        tail = np.concatenate([hist[::-1].cumsum()[::-1], [0.0]])
        start = max(int(0.7 * self.bins), levels)
        best_i, best_kl = self.bins, np.inf
        for i in range(start, self.bins + 1):
            if hist[i - 1] == 0:
                continue  # reference skips candidates ending in an empty bin
            p = hist[:i].copy()
            p[i - 1] += tail[i]  # clip outliers into the edge bin
            # quantize the first i bins down to `levels` buckets:
            # per-bucket mean over the *nonzero* source bins, vectorized
            # via reduceat on the bucket boundaries
            bounds = np.floor(np.arange(levels) * (i / levels)).astype(int)
            sums = np.add.reduceat(hist[:i], bounds)
            counts = np.add.reduceat(nonzero[:i], bounds)
            means = np.divide(sums, counts,
                              out=np.zeros(levels), where=counts > 0)
            # scatter each bucket mean back over its nonzero bins
            bucket_of = np.searchsorted(bounds, np.arange(i),
                                        side="right") - 1
            q = means[bucket_of] * nonzero[:i]
            pn, qn = p / p.sum(), q / max(q.sum(), 1e-12)
            mask = pn > 0
            kl = float(np.sum(pn[mask] * np.log(
                pn[mask] / np.maximum(qn[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_i = kl, i
        return (best_i + 0.5) * (edge / self.bins)

    def scales(self) -> Dict[str, float]:
        """Per-activation-var quantization scale (threshold)."""
        if self._scales is None:
            if not self._absmax:
                raise RuntimeError(
                    "no samples collected: call sample_data() first")
            out = {}
            for name in self._act_vars:
                if self.algo == "KL" and self._hist.get(name) is not None \
                        and self._hist[name].sum() > 0:
                    out[name] = self._kl_threshold(
                        self._hist[name], self._hist_edge[name])
                else:
                    out[name] = self._absmax.get(name, 1.0) or 1.0
            self._scales = out
        return dict(self._scales)

    # ------------------------------------------------------------ rewrite
    def generate_calibrated_program(self) -> Program:
        """Clone the program and insert fixed-scale fake-quant ops on
        every quantizable edge: activations use the calibrated
        thresholds, weights use their abs-max from the scope (the
        reference computes weight scales the same way,
        utility.py:__get_max_range_by_var_name)."""
        scales = self.scales()
        p = self.program.clone(for_test=True)
        graph = Graph(p)
        quantized: Dict[str, str] = {}
        for op_type in self.op_types:
            for slot in _WEIGHT_SLOTS.get(op_type, ()) \
                    + _ACT_SLOTS.get(op_type, ()):
                pm = PatternMatcher()
                target = pm.new_op("target", op_type=op_type)
                x = pm.new_var("x")
                pm.feeds(x, target, slot=slot)
                for m in pm.match(graph):
                    self._quantize_edge(graph, m["x"], m["target"], slot,
                                        scales, quantized)
        graph.materialize()
        p._bump()
        return p

    def save_int8_model(self, dirname, executor, feeded_var_names,
                        target_vars, model_filename=None,
                        params_filename=None):
        """Calibrate and export in one call (reference utility.py:69):
        generate the fixed-scale program and write it through
        io.save_inference_model, scale vars included."""
        from ... import io

        qprog = self.generate_calibrated_program()
        targets = [qprog.global_block().var(getattr(v, "name", v))
                   for v in target_vars]
        return io.save_inference_model(
            dirname, list(feeded_var_names), targets, executor,
            main_program=qprog, model_filename=model_filename,
            params_filename=params_filename)

    def _quantize_edge(self, graph, xnode, opnode, slot, scales, quantized):
        name = xnode.name
        if name.endswith(".calib_q"):
            return
        if name in quantized:
            graph.rewire_input(opnode, slot, name, quantized[name])
            return
        var = xnode.var
        if isinstance(var, Parameter):
            w = self.scope.find_var(name)
            scale = float(np.abs(np.asarray(w.detach().cpu())).max()) \
                if w is not None else 1.0
        elif name in scales:
            scale = scales[name]
        else:
            return  # not sampled (e.g. dead branch): leave edge fp32
        qname = name + ".calib_q"
        scale_name = name + ".calib_scale"
        graph.create_var_node(qname, shape=getattr(var, "shape", None),
                              dtype=getattr(var, "dtype", "float32"),
                              stop_gradient=True)
        graph.create_var_node(scale_name, shape=(1,), dtype="float32",
                              persistable=True, stop_gradient=True)
        self.scope.set_var(scale_name,
                           torch.tensor([scale or 1.0], dtype=torch.float32,
                                        device=self._device))
        graph.insert_op_node(
            "fake_quantize_abs_max",
            {"X": [name], "InScale": [scale_name]},
            {"Out": [qname], "OutScale": [scale_name + ".out"]},
            {"bit_length": self.bits, "is_test": True})
        graph.create_var_node(scale_name + ".out", shape=(1,),
                              dtype="float32", stop_gradient=True)
        quantized[name] = qname
        graph.rewire_input(opnode, slot, name, qname)
