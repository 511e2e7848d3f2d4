"""Dygraph layers (reference python/paddle/fluid/imperative/nn.py: Conv2D,
Pool2D, FC, BatchNorm, Embedding). Each forward issues eager ops through
trace_op, so autograd comes from the shared tape."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import Layer, VarBase, trace_op

__all__ = ["FC", "Conv2D", "Pool2D", "BatchNorm", "Embedding"]


class FC(Layer):
    def __init__(self, name_scope: str, size: int, num_flatten_dims: int = 1,
                 act: Optional[str] = None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._num_flatten_dims = num_flatten_dims
        self._act = act
        self._w: Optional[VarBase] = None
        self._b: Optional[VarBase] = None

    def forward(self, x: VarBase) -> VarBase:
        in_dim = int(np.prod(x.shape[self._num_flatten_dims:]))
        if self._w is None:
            self._w = self.create_parameter("w", (in_dim, self._size),
                                            self._dtype)
            self._b = self.create_parameter("b", (self._size,), self._dtype,
                                            initializer=0.0)
        out = trace_op("mul", {"X": [x], "Y": [self._w]},
                       {"x_num_col_dims": self._num_flatten_dims})["Out"][0]
        out = trace_op("elementwise_add", {"X": [out], "Y": [self._b]},
                       {"axis": -1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Conv2D(Layer):
    def __init__(self, name_scope: str, num_channels: int, num_filters: int,
                 filter_size, stride=1, padding=0, groups: int = 1,
                 act: Optional[str] = None, dtype="float32"):
        super().__init__(name_scope, dtype)
        ks = (filter_size if isinstance(filter_size, (list, tuple))
              else (filter_size, filter_size))
        self._attrs = {
            "strides": list(stride if isinstance(stride, (list, tuple))
                            else (stride, stride)),
            "paddings": list(padding if isinstance(padding, (list, tuple))
                             else (padding, padding)),
            "groups": groups,
            "dilations": [1, 1],
        }
        self._act = act
        self._filter = self.create_parameter(
            "filter", (num_filters, num_channels // groups) + tuple(ks), dtype)
        self._b = self.create_parameter("b", (num_filters,), dtype,
                                        initializer=0.0)

    def forward(self, x: VarBase) -> VarBase:
        out = trace_op("conv2d", {"Input": [x], "Filter": [self._filter]},
                       dict(self._attrs))["Output"][0]
        b4 = trace_op("reshape", {"X": [self._b]},
                      {"shape": [1, -1, 1, 1]})["Out"][0]
        out = trace_op("elementwise_add", {"X": [out], "Y": [b4]}, {})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Pool2D(Layer):
    def __init__(self, name_scope: str, pool_size=2, pool_type="max",
                 pool_stride=2, pool_padding=0, global_pooling=False,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        to2 = lambda v: list(v) if isinstance(v, (list, tuple)) else [v, v]
        self._attrs = {
            "ksize": to2(pool_size),
            "pooling_type": pool_type,
            "strides": to2(pool_stride),
            "paddings": to2(pool_padding),
            "global_pooling": global_pooling,
        }

    def forward(self, x: VarBase) -> VarBase:
        return trace_op("pool2d", {"X": [x]}, dict(self._attrs))["Out"][0]


class BatchNorm(Layer):
    def __init__(self, name_scope: str, num_channels: int, act=None,
                 epsilon: float = 1e-5, momentum: float = 0.9,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._act = act
        self._eps = epsilon
        self._momentum = momentum
        self._scale = self.create_parameter("scale", (num_channels,), dtype,
                                            initializer=1.0)
        self._bias = self.create_parameter("bias", (num_channels,), dtype,
                                           initializer=0.0)
        self._mean = VarBase(np.zeros(num_channels, np.float32),
                             name="mean", stop_gradient=True)
        self._variance = VarBase(np.ones(num_channels, np.float32),
                                 name="variance", stop_gradient=True)

    def forward(self, x: VarBase) -> VarBase:
        outs = trace_op(
            "batch_norm",
            {"X": [x], "Scale": [self._scale], "Bias": [self._bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            {"epsilon": self._eps, "momentum": self._momentum,
             "is_test": False})
        out = outs["Y"][0]
        # update running stats IN PLACE: the VarBase objects stay
        # identity-stable, so a trace capture that registered them as
        # persistable state keeps pointing at the layer's live stats
        # across re-traces (capture.py binds state by object identity)
        if outs.get("MeanOut"):
            self._mean.value = outs["MeanOut"][0].value
        if outs.get("VarianceOut"):
            self._variance.value = outs["VarianceOut"][0].value
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Embedding(Layer):
    def __init__(self, name_scope: str, size: Sequence[int], dtype="float32",
                 is_sparse: bool = False):
        super().__init__(name_scope, dtype)
        self._size = list(size)
        scale = 1.0 / np.sqrt(size[1])
        self._w = self.create_parameter(
            "embedding", tuple(size), dtype,
            initializer=lambda s: np.random.uniform(-scale, scale, size=s))

    def forward(self, ids: VarBase) -> VarBase:
        return trace_op("lookup_table",
                        {"Ids": [ids], "W": [self._w]}, {})["Out"][0]


class GRUUnit(Layer):
    """Single GRU step layer (reference imperative/nn.py:474). `size` is
    3 * hidden_dim, matching the graph-mode layers.gru_unit contract."""

    def __init__(self, name_scope: str, size: int, param_attr=None,
                 bias_attr=None, activation="tanh",
                 gate_activation="sigmoid", origin_mode=False,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._activation = activation
        self._gate_activation = gate_activation
        self._origin_mode = origin_mode
        self._w: Optional[VarBase] = None
        self._b: Optional[VarBase] = None

    def forward(self, input: VarBase, hidden: VarBase):
        D = self._size // 3
        if self._w is None:
            self._w = self.create_parameter("w", (D, 3 * D), self._dtype)
            self._b = self.create_parameter("b", (1, 3 * D), self._dtype,
                                            initializer=0.0)
        outs = trace_op(
            "gru_unit",
            {"Input": [input], "HiddenPrev": [hidden], "Weight": [self._w],
             "Bias": [self._b]},
            {"activation": self._activation,
             "gate_activation": self._gate_activation,
             "origin_mode": self._origin_mode})
        return (outs["Hidden"][0], outs["ResetHiddenPrev"][0],
                outs["Gate"][0])
