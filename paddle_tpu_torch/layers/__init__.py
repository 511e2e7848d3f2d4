"""layers: user-facing op-builder API, the layer modules of
paddle_tpu/layers that the serving and training slices need (nn.py,
tensor.py, ops.py and learning_rate_scheduler.py are copies; io.py holds
``data``)."""

from . import io, learning_rate_scheduler, nn, ops, tensor  # noqa: F401
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
