"""Static program verifier: shape/dtype inference, the IR lint suite,
the shared dataflow engine, translation validation and the roofline
cost model.

The port's counterpart of paddle_tpu/analysis/, trimmed to the engines
the pass pipeline and the Executor use: importing this package attaches
the shape rules of the op types the port lowers (``shape_rules.SKIPPED``
names the others), and

* ``verify_program`` runs inference + the lint suite and raises
  ``ProgramVerifyError`` on errors; the Executor runs it at prepare time
  when ``PADDLE_TPU_VALIDATE=1``;
* the pass manager (core/passes/) re-verifies after every structural
  pass and checks each pass's rewrite log with ``validate_rewrite``.

* ``CostAnalysis`` prices a Program's ops in FLOPs and bytes (the
  copied ``cost_rules`` table) against ``DeviceModel.current()`` (the
  H100's peaks by dtype, probed overheads) for the unified autotuner
  (kernels/autotune.py); ``predict_step_seconds`` is its one-call form
  and ``register_cost_rule`` adds a rule.

* ``validate_distributed`` / ``validate_transpile`` prove a
  ``DistributeTranspiler``'s trainer and pserver programs well-formed
  across the wire (distributed.py, a copy: wire typing, shard coverage,
  barrier ordering, translation validation against the rewrite log, the
  pserver memory proof); the pserver loop runs
  ``pserver_spec_findings`` under ``PADDLE_TPU_VALIDATE=1``.

The numerics and memory lint rules build ``ranges.RangeAnalysis`` and
``memory.MemoryAnalysis`` lazily, as in the JAX package.
"""

from . import shape_rules  # noqa: F401  (attaches the core rule set)
from .cost import (CostAnalysis, DeviceModel,  # noqa: F401
                   cost_model_enabled, predict_step_seconds)
from .cost_rules import register_cost_rule  # noqa: F401 (attaches rules)
from .dataflow import Dataflow  # noqa: F401
from .distributed import (BARRIER_OPS, WIRE_OPS,  # noqa: F401
                          pserver_spec_findings, shard_fit_report,
                          validate_distributed, validate_transpile)
from .infer import (DIST_RULES, Finding, InferContext,  # noqa: F401
                    InferError, ProgramVerifyError,
                    infer_program_shapes, validation_enabled,
                    verify_program)
from .lint import LINT_RULES, lint_program  # noqa: F401
from .tv import (ProgramSnapshot, RewriteViolation,  # noqa: F401
                 describe_rewrites, tv_enabled, validate_rewrite)

__all__ = [
    "BARRIER_OPS",
    "CostAnalysis",
    "DIST_RULES",
    "Dataflow",
    "DeviceModel",
    "Finding",
    "InferContext",
    "InferError",
    "LINT_RULES",
    "ProgramSnapshot",
    "ProgramVerifyError",
    "RewriteViolation",
    "WIRE_OPS",
    "describe_rewrites",
    "cost_model_enabled",
    "infer_program_shapes",
    "lint_program",
    "predict_step_seconds",
    "pserver_spec_findings",
    "register_cost_rule",
    "shard_fit_report",
    "tv_enabled",
    "validate_distributed",
    "validate_rewrite",
    "validate_transpile",
    "validation_enabled",
    "verify_program",
]
