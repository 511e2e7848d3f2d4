"""layers: user-facing op-builder API, the layer modules of
paddle_tpu/layers that the serving, training, decoding and
image-classification slices need (nn.py, tensor.py, ops.py, decode.py,
metric_op.py and learning_rate_scheduler.py are copies; io.py holds
``data``)."""

from . import (decode, io, learning_rate_scheduler, metric_op,  # noqa: F401
               nn, ops, tensor)
from .decode import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
