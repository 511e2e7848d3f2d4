"""Op lowerings: importing this package registers every op.

The port registers torch lowerings for the op types of the BERT-base
training program (forward, grads, Adam) and its startup program, module
by module beside their paddle_tpu/ops counterparts.
"""

from . import (activations, attention, basic, math, nn,  # noqa: F401
               optimizer_ops, tensor_ops)
