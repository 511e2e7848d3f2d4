"""Eager optimizers: the graph tier's registered optimizer ops
(``ops/optimizer_ops.py``) driven per-parameter through ``trace_op``.

One update implementation serves both worlds, exactly like gradients:
``Adam.step`` issues the SAME ``adam`` op the graph
``optimizer.Adam._append_optimize_op`` appends, with the same
accumulator initial values (moments zero, beta pows 1.0 shaped ``[1]``),
so an eager train step and its captured Program are the same math —
the bitwise train-step parity ``capture.py`` promises rides on this.

Under an active capture, each accumulator is registered as persistable
captured state and every ``<X>Out`` aliases its input var, so the
captured block reads exactly like a graph-built optimizer step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import VarBase, trace_op

__all__ = ["Adam", "SGD"]


class _EagerOptimizer:
    def __init__(self, learning_rate: float):
        self._lr = VarBase(np.full((1,), float(learning_rate), np.float32),
                           name="learning_rate", stop_gradient=True)

    @property
    def learning_rate(self) -> float:
        return float(self._lr.value[0])

    @learning_rate.setter
    def learning_rate(self, value: float):
        import torch

        self._lr.value = torch.full_like(self._lr.value, float(value))

    def minimize(self, loss: VarBase,
                 parameter_list: Optional[Sequence[VarBase]] = None
                 ) -> None:
        """backward() + step(): the eager analog of graph
        ``Optimizer.minimize`` (one call per train step)."""
        loss.backward()
        self.step(parameter_list or [])

    def step(self, parameters: Sequence[VarBase]) -> None:
        for p in parameters:
            if p._grad is None or p.stop_gradient:
                continue
            grad = VarBase(p._grad, name=(p.name or "param") + "@GRAD",
                           stop_gradient=True)
            self._apply(p, grad)

    def _apply(self, p: VarBase, grad: VarBase) -> None:
        raise NotImplementedError

    def _state(self, store: Dict[int, List[VarBase]], p: VarBase,
               specs) -> List[VarBase]:
        """Lazily create per-parameter accumulators; identity-stable
        VarBases so captured state names stay pinned across re-traces."""
        acc = store.get(id(p))
        if acc is None:
            pname = p.name or "param"
            acc = [VarBase(np.full(shape, fill, np.float32)
                           if shape != () else np.asarray(p.value) * 0,
                           name="%s_%s" % (pname, nm), stop_gradient=True)
                   for nm, shape, fill in specs]
            store[id(p)] = acc
        return acc


class SGD(_EagerOptimizer):
    """Plain SGD through the registered ``sgd`` op."""

    def _apply(self, p: VarBase, grad: VarBase) -> None:
        outs = trace_op(
            "sgd",
            {"Param": [p], "Grad": [grad], "LearningRate": [self._lr]},
            {})
        p.value = outs["ParamOut"][0].value


class Adam(_EagerOptimizer):
    """Adam through the registered ``adam`` op — accumulators match the
    graph optimizer's exactly (moments zero like the param, beta pows
    ``[1]``-shaped 1.0)."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._acc: Dict[int, List[VarBase]] = {}

    def _apply(self, p: VarBase, grad: VarBase) -> None:
        import torch

        pname = p.name or "param"
        acc = self._acc.get(id(p))
        if acc is None:
            zeros = lambda: VarBase(torch.zeros_like(p.value))  # noqa: E731
            m1, m2 = zeros(), zeros()
            m1.name, m2.name = pname + "_moment1", pname + "_moment2"
            b1p = VarBase(np.ones((1,), np.float32),
                          name=pname + "_beta1_pow", stop_gradient=True)
            b2p = VarBase(np.ones((1,), np.float32),
                          name=pname + "_beta2_pow", stop_gradient=True)
            m1.stop_gradient = m2.stop_gradient = True
            acc = [m1, m2, b1p, b2p]
            self._acc[id(p)] = acc
        m1, m2, b1p, b2p = acc
        outs = trace_op(
            "adam",
            {"Param": [p], "Grad": [grad], "Moment1": [m1], "Moment2": [m2],
             "Beta1Pow": [b1p], "Beta2Pow": [b2p],
             "LearningRate": [self._lr]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})
        p.value = outs["ParamOut"][0].value
        m1.value = outs["Moment1Out"][0].value
        m2.value = outs["Moment2Out"][0].value
        b1p.value = outs["Beta1PowOut"][0].value
        b2p.value = outs["Beta2PowOut"][0].value
