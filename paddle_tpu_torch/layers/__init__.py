"""layers: user-facing op-builder API, the layer modules of
paddle_tpu/layers that the serving, training, decoding,
image-classification, sequence and loss slices need (control_flow.py,
rnn_blocks.py, decode.py, nn.py, tensor.py, ops.py, sequence.py,
scan_ext.py, metric_op.py, loss.py, detection.py and
learning_rate_scheduler.py are copies; io.py holds ``data``), imported
in the JAX package's order."""

from . import (control_flow, decode, detection, io,  # noqa: F401
               learning_rate_scheduler, loss, metric_op, nn, ops,
               rnn_blocks, scan_ext, sequence, tensor)
from .control_flow import *  # noqa: F401,F403
from .rnn_blocks import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .scan_ext import *  # noqa: F401,F403
