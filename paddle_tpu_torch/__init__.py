"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It keeps the JAX package's Program / op-type / slot / attr schema, its
parameter names and its layouts, so one Program and one set of weights
run in both packages. Ops lower to PyTorch; the TPU's Pallas kernels
become hand-written CUDA kernels for Hopper (csrc/, built with nvcc at
first use). ``optimizer.Adam(...).minimize(loss)`` appends the backward
and the updates, and ``Executor.run`` trains; wrapped in
``contrib.mixed_precision.decorate``, it trains under bf16 AMP
(core/amp.py). ``Executor.train_loop`` / ``run_pipelined`` drive the
steps over a reader with a ``DevicePrefetcher`` (core/pipeline.py).
Entry points run on the card unless the caller passes
``CPUPlace()`` (or ``AnalysisConfig.disable_gpu()``).

Import as ``import paddle_tpu_torch as fluid``.
"""

from . import ops as _ops  # registers all op lowerings  # noqa: F401
from . import (clip, contrib, convert, core, evaluator,  # noqa: F401
               flags, inference, initializer, io, layers,
               learning_rate_decay, metrics, models, nets, optimizer,
               profiler, reader, regularizer)
from .core.executor import Executor  # noqa: F401
from .core.pipeline import (ConstFeedCache, DevicePrefetcher,  # noqa: F401
                            FetchHandle, WindowFeed)
from .reader import batch  # noqa: F401  (paddle.batch top-level parity)
from .flags import get_flag, set_flag  # noqa: F401
from .core.place import CPUPlace, CUDAPlace  # noqa: F401
from .core.program import (  # noqa: F401
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
    unique_name,
)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401

name = "paddle_tpu_torch"
