"""Op lowerings: importing this package registers every op.

The port registers torch lowerings for the op types of the BERT-base
training program (forward, grads, Adam), its startup program, the
learning-rate schedules and recompute segments, module by module beside
their paddle_tpu/ops counterparts.
"""

from . import (activations, attention, basic, fused_ops,  # noqa: F401
               math, nn, optimizer_ops, recompute_ops, tensor_ops)
