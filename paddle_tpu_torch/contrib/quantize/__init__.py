"""QuantizeTranspiler: quantization-aware-training program rewrite.

A copy of paddle_tpu/contrib/quantize/__init__.py (framework-neutral;
tests/test_torch_isolation.py pins it). Analog of Fluid's
contrib/quantize/quantize_transpiler.py and
contrib/slim/quantization/quantization_pass.py:
insert fake-quant ops on the weights and activations feeding the heavy
compute ops (conv2d/depthwise_conv2d/mul/matmul) so training sees int8
rounding, and freeze the collected scales for inference export.

The surgery itself is the registered ir pass "quantize_pass"
(core/ir.py substrate): a PatternMatcher finds every (input var ->
quantizable op slot) edge — the GraphPatternDetector idiom of the
reference's quantization_pass.cc — and the graph is rewired through
fresh fake-quant op nodes, then materialized back into the program in
dependency order.

Call `training_transpile(program, startup_program)` BEFORE
optimizer.minimize: the straight-through-estimator grads of the quant ops
(ops/quant_ops.py) then flow through append_backward like any other op —
the reference instead patches grad ops post-hoc.
"""

from __future__ import annotations

from typing import Optional

from ...core.ir import Graph, Pass, PatternMatcher, register_pass
from ...core.program import (Parameter, Program, default_main_program,
                             default_startup_program)

__all__ = ["QuantizeTranspiler", "QuantizePass", "QUANTIZABLE_OP_TYPES"]

QUANTIZABLE_OP_TYPES = ("conv2d", "depthwise_conv2d", "mul", "matmul")

_WEIGHT_SLOTS = {
    "conv2d": ("Filter",),
    "depthwise_conv2d": ("Filter",),
    "mul": ("Y",),
    "matmul": ("Y",),
}
_ACT_SLOTS = {
    "conv2d": ("Input",),
    "depthwise_conv2d": ("Input",),
    "mul": ("X",),
    "matmul": ("X",),
}


@register_pass("quantize_pass")
class QuantizePass(Pass):
    """Insert fake-quant ops on quantizable-op inputs via the pattern
    matcher; set `startup` to also emit the scale-state initializers."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 act_type="moving_average_abs_max", moving_rate=0.9,
                 startup: Optional[Program] = None):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = act_type
        self.moving_rate = moving_rate
        self.startup = startup

    def apply(self, graph: Graph) -> Graph:
        quantized = {}  # var name -> quantized var name (shared consumers)
        for op_type in QUANTIZABLE_OP_TYPES:
            for slot in _WEIGHT_SLOTS[op_type] + _ACT_SLOTS[op_type]:
                pm = PatternMatcher()
                # op role first: the matcher then narrows the var role to
                # the bound op's inputs instead of scanning every var
                target = pm.new_op("target", op_type=op_type)
                x = pm.new_var("x")
                pm.feeds(x, target, slot=slot)
                for m in pm.match(graph):
                    self._quantize_edge(graph, m["x"], m["target"], slot,
                                        quantized)
        return graph

    def _quantize_edge(self, graph, xnode, opnode, slot, quantized):
        name = xnode.name
        if name.endswith(".quantized"):
            return  # already-rewired edge matched again
        if name in quantized:
            graph.rewire_input(opnode, slot, name, quantized[name])
            return
        var = xnode.var
        is_weight = isinstance(var, Parameter)
        bits = self.weight_bits if is_weight else self.activation_bits
        qname = name + ".quantized"
        scale_name = name + ".scale"
        graph.create_var_node(qname, shape=getattr(var, "shape", None),
                              dtype=getattr(var, "dtype", "float32"),
                              stop_gradient=False)
        graph.create_var_node(scale_name, shape=(1,), dtype="float32",
                              persistable=True, stop_gradient=True)

        if is_weight or self.act_type == "abs_max":
            graph.insert_op_node(
                "fake_quantize_abs_max",
                {"X": [name]}, {"Out": [qname], "OutScale": [scale_name]},
                {"bit_length": bits})
            self._init_zero(scale_name)
        else:
            ins = {"X": [name], "InScale": [scale_name]}
            outs = {"Out": [qname], "OutScale": [scale_name]}
            attrs = {"bit_length": bits, "moving_rate": self.moving_rate}
            state_vars = []
            if self.act_type == "moving_average_abs_max":
                for extra in ("accum", "state"):
                    sn = "%s.%s" % (name, extra)
                    graph.create_var_node(sn, shape=(1,), dtype="float32",
                                          persistable=True,
                                          stop_gradient=True)
                    state_vars.append(sn)
                ins["InAccum"], ins["InState"] = [state_vars[0]], [state_vars[1]]
                outs["OutAccum"], outs["OutState"] = [state_vars[0]], [state_vars[1]]
                op_type = "fake_quantize_moving_average_abs_max"
            else:
                op_type = "fake_quantize_range_abs_max"
            graph.insert_op_node(op_type, ins, outs, attrs)
            for sn in state_vars + [scale_name]:
                self._init_zero(sn)
        quantized[name] = qname
        graph.rewire_input(opnode, slot, name, qname)

    def _init_zero(self, name: str):
        if self.startup is None:
            return
        sb = self.startup.global_block()
        if any(name in op.output_names() for op in sb.ops):
            return
        sb.create_var(name=name, shape=(1,), dtype="float32",
                      persistable=True, stop_gradient=True)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": [1], "value": 0.0, "dtype": "float32"})


class QuantizeTranspiler:
    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 activation_quantize_type: str = "moving_average_abs_max",
                 weight_quantize_type: str = "abs_max",
                 moving_rate: float = 0.9):
        assert activation_quantize_type in (
            "abs_max", "moving_average_abs_max", "range_abs_max")
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.moving_rate = moving_rate

    # ------------------------------------------------------------ training
    def training_transpile(self, program: Optional[Program] = None,
                           startup_program: Optional[Program] = None):
        """Insert fake-quant ops in-place by running quantize_pass over
        the ir Graph of the program (quantize_transpiler.py
        training_transpile analog)."""
        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        graph = Graph(program)
        QuantizePass(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            act_type=self.act_type,
            moving_rate=self.moving_rate,
            startup=startup,
        ).apply(graph)
        graph.materialize()

    # ------------------------------------------------------------ freezing
    def freeze_program(self, program: Program) -> Program:
        """Freeze collected scales for inference: quant ops switch to
        is_test (scale read from state, never updated). The reference's
        freeze_program additionally rewrites weights to int8 storage, which
        has no TPU benefit (bf16 compute); the scales are what deployment
        needs."""
        p = program.clone(for_test=True)
        for b in p.blocks:
            for op in b.ops:
                if op.type.startswith("fake_quantize"):
                    op.attrs["is_test"] = True
                    if op.type == "fake_quantize_abs_max":
                        # feed the collected scale back in so inference
                        # reads it instead of recomputing per batch
                        op.inputs.setdefault("InScale",
                                             list(op.output("OutScale")))
        p._bump()
        return p
