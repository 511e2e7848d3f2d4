"""Distributed training stack.

The port's counterpart of paddle_tpu/distributed/. Two paths, mirroring
the reference (SURVEY §2.9):

* **Collective data parallel**: ``CompiledProgram.with_data_parallel``
  over the mesh engine (parallel/engine.py); ``init_parallel_env``
  (parallel/env.py) joins a ``torch.distributed`` process group from the
  launcher env contract (PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS).
* **Parameter server**: ``DistributeTranspiler`` splits the program into
  trainer and pserver halves over the native TCP RPC transport
  (native/ps_service.cc, the port's own copy), for huge sparse
  embeddings and CTR-style workloads (reference operators/distributed +
  listen_and_serv). A trainer's step runs on its executor's device,
  the card by default, with the six PS ops reading and writing on the
  host inside it; a pserver's dense updates run on its executor's
  device too.

The elastic tier's membership (``membership.py``: heartbeat leases and
the reshard math, over the same transport) and the multi-process
launcher (``launch.py``, ``python -m paddle_tpu_torch.distributed.launch``)
are copies of the JAX package's.
"""

from ..parallel.env import ParallelEnv, init_parallel_env  # noqa: F401
from .membership import (  # noqa: F401
    HeartbeatSender,
    MembershipServer,
    MembershipView,
    TrainerLease,
    make_world,
    reshard,
    shard_assignment,
    world_from_manifest,
)
from .rpc import (  # noqa: F401
    PeerGoneError,
    RPCClient,
    RPCError,
    RPCServer,
    SelectedRows,
    compress_mode,
)
from .transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
    HashName,
    RoundRobin,
)
