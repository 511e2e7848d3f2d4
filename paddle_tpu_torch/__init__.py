"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It keeps the JAX package's Program / op-type / slot / attr schema, its
parameter names and its layouts, so one Program and one set of weights
run in both packages. Ops lower to PyTorch; the TPU's Pallas kernels
become hand-written CUDA kernels for Hopper (csrc/, built with nvcc at
first use). ``optimizer.Adam(...).minimize(loss)`` appends the backward
and the updates, and ``Executor.run`` trains; wrapped in
``contrib.mixed_precision.decorate``, it trains under bf16 AMP
(core/amp.py). ``Executor.train_loop`` / ``run_pipelined`` drive the
steps over a reader with a ``DevicePrefetcher`` (core/pipeline.py);
``layers.PyReader``, ``DataFeeder``, ``dataset``, ``AsyncExecutor`` over
the native slot feed and ``contrib.Trainer`` / ``Inferencer`` feed and
drive it the Fluid way. ``CompiledProgram(main).with_data_parallel()``
and ``ParallelExecutor`` run a step over a mesh of positions that share
one device (``parallel.ParallelEngine``: data, tensor, sequence, expert
and pipeline axes).
Entry points run on the card unless the caller passes
``CPUPlace()`` (or ``AnalysisConfig.disable_gpu()``).

Import as ``import paddle_tpu_torch as fluid``.
"""

from . import ops as _ops  # registers all op lowerings  # noqa: F401
from . import (clip, contrib, convert, core, evaluator,  # noqa: F401
               flags, imperative, inference, initializer, io, layers,
               learning_rate_decay, metrics, models, nets, optimizer,
               parallel, profiler, reader, regularizer)
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy, ParallelExecutor)
from .core.executor import Executor  # noqa: F401
from .core.pipeline import (ConstFeedCache, DevicePrefetcher,  # noqa: F401
                            FetchHandle, WindowFeed)
from .reader import batch  # noqa: F401  (paddle.batch top-level parity)
from .flags import get_flag, set_flag  # noqa: F401
from .core.place import (CPUPlace, CUDAPinnedPlace,  # noqa: F401
                         CUDAPlace)
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
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from . import (average, compat, data_feed_desc, dataset,  # noqa: F401
               lod_tensor, recordio_writer, version)
from .lod_tensor import (LoDTensor, LoDTensorArray, Tensor,  # noqa: F401
                         create_lod_tensor, create_random_int_lodtensor)
from .async_executor import AsyncExecutor, DataFeedDesc  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401

__version__ = version.full_version

name = "paddle_tpu_torch"
