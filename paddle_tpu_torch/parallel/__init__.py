"""Mesh-parallel engine: the ParallelExecutor of the port.

The port of paddle_tpu/parallel (reference analog:
paddle/fluid/framework/parallel_executor.cc:184). One controller runs
the Program over a mesh of positions (mesh.py) that share one device:
every op keeps its global semantics, the rules place feeds and state
(sharding.py), and ring attention, the experts of ``moe_ffn`` and the
pipeline schedule run per position in rounds of compute and collectives
(ring_attention.py, moe.py, pipeline.py).
"""

from .engine import ParallelEngine
from .sharding import ShardingRules
from .env import init_parallel_env, ParallelEnv
from .moe import moe_apply
from .pipeline import pipeline_apply
from .ring_attention import ring_attention

__all__ = ["ParallelEngine", "ShardingRules", "init_parallel_env",
           "ParallelEnv", "moe_apply", "pipeline_apply", "ring_attention"]
