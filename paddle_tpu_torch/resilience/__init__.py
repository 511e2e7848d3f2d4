"""resilience: the fault-injection plane and the shared retry backoff.

The port's counterpart of paddle_tpu/resilience/, as far as the
parameter-server transport needs it (distributed/rpc.py):

* :mod:`~paddle_tpu_torch.resilience.faults`: a deterministic, seeded
  fault-injection plane. A :class:`FaultPlan` arms named sites compiled
  into the hot paths (``rpc.send`` here) to raise, delay, wedge or
  SIGKILL on chosen occurrences, installed via context manager or
  ``PADDLE_TPU_FAULT_PLAN``.
* :mod:`~paddle_tpu_torch.resilience.backoff`: the full-jitter
  exponential backoff of the RPC client's retries.

Both are copies of the JAX package's modules. The watchdog, the
supervisor and the elastic job are not ported yet.
"""

from .backoff import backoff_delay, millis_env  # noqa: F401
from .faults import (FaultPlan, FaultSpec, InjectedFault,  # noqa: F401
                     active_plan, fault_point)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "fault_point",
    "active_plan",
    "backoff_delay", "millis_env",
]
