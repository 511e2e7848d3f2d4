"""Serving scheduler: request queue, dynamic micro-batching, continuous
batching for autoregressive decode, and the fleet tier above them.

The port's counterpart of paddle_tpu/serving/, with the same five
pieces and names:

* ``queue``   — bounded admission queue: backpressure (reject-when-
  full, counted), per-request deadlines, cancellation, per-request
  futures, per-tenant outcome labels.
* ``batcher`` — dynamic micro-batching for ``Predictor`` workloads:
  coalesce within a max-wait window, ride the Predictor's warm-up
  buckets (each a captured CUDA graph on the card), slice per-request
  results back out.
* ``engine``  — continuous batching for GPT decode: one fixed-b_max
  decode step whose per-slot KV caches admit new sequences at step
  boundaries (prefill-then-insert, written in place into the caches
  the captured graphs hold) and retire finished ones immediately;
  optionally speculative and prefix-cached.
* ``prefix``  — the prefix/KV-cache store (host numpy rows).
* ``router``  — SLO-aware multi-replica routing: per-tenant quotas,
  reject-early admission against projected queue wait, and supervised
  replica health.

``queue``, ``prefix``, ``batcher`` and ``router`` are copies of the JAX
package's (tests/test_torch_isolation.py pins them); ``engine`` is a
port. All report through ``paddle_tpu_torch.observe``. Not imported by
``import paddle_tpu_torch``: ``from paddle_tpu_torch import serving``.
"""

from __future__ import annotations

from .batcher import MicroBatcher
from .engine import DecodeEngine
from .engine import MemoryBudgetExceeded
from .prefix import PrefixStore
from .queue import (Cancelled, DeadlineExpired, QueueFull, RequestQueue,
                    ServingRequest)
from .router import ReplicaRouter, TenantQuotaExceeded

__all__ = ["Cancelled", "DeadlineExpired", "DecodeEngine",
           "MemoryBudgetExceeded", "MicroBatcher", "PrefixStore",
           "QueueFull", "ReplicaRouter", "RequestQueue",
           "ServingRequest", "TenantQuotaExceeded"]
