"""layers: user-facing op-builder API, the layer modules of
paddle_tpu/layers that the serving and training slices need (nn.py,
tensor.py and ops.py are copies; io.py holds ``data``)."""

from . import io, nn, ops, tensor  # noqa: F401
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
