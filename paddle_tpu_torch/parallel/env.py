"""Multi-host bootstrap: the gen_nccl_id / NCCL2-mode analog.

Reference: DistributeTranspiler "nccl2" mode (distribute_transpiler.py:226)
makes rank 0 create an ncclUniqueId and ship it over gRPC
(gen_nccl_id_op.cc); NCCLContextMap then inits comms with
nranks/rank (nccl_helper.h:129). The launcher contract is env vars
(distributed/launch.py:40-80): PADDLE_TRAINER_ID, PADDLE_TRAINER_ENDPOINTS,
PADDLE_CURRENT_ENDPOINT.

The port: the same env contract feeds
``torch.distributed.init_process_group`` — trainer 0's endpoint is the
rendezvous (``tcp://<endpoint>``) that takes the place of the
broadcasted ncclUniqueId, with gloo on the CPU and NCCL on the card. At
world size 1 nothing is initialized: the engine (parallel/engine.py)
needs no process group for a mesh whose positions share one device.
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = ["ParallelEnv", "init_parallel_env"]


class ParallelEnv:
    """Parsed cluster description from the launcher env contract."""

    def __init__(self, env: Optional[dict] = None):
        e = env if env is not None else os.environ
        self.trainer_id = int(e.get("PADDLE_TRAINER_ID", "0"))
        eps = e.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints: List[str] = [x for x in eps.split(",") if x]
        self.current_endpoint = e.get(
            "PADDLE_CURRENT_ENDPOINT",
            self.trainer_endpoints[self.trainer_id]
            if self.trainer_id < len(self.trainer_endpoints) else "",
        )
        self.nranks = max(len(self.trainer_endpoints), 1)

    @property
    def rank(self) -> int:
        return self.trainer_id

    @property
    def world_size(self) -> int:
        return self.nranks


_initialized = False


def init_parallel_env(env: Optional[ParallelEnv] = None) -> ParallelEnv:
    """Initialize the multi-process runtime. World size 1 is a no-op;
    otherwise every process joins trainer 0's rendezvous with its rank,
    over NCCL where a card is visible, else gloo."""
    global _initialized
    penv = env or ParallelEnv()
    if _initialized or penv.nranks <= 1:
        _initialized = True
        return penv
    import torch
    import torch.distributed as dist

    coordinator = penv.trainer_endpoints[0]
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=penv.nranks, rank=penv.trainer_id)
    _initialized = True
    return penv
