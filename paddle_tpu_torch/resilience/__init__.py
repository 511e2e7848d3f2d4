"""resilience: fault injection, wedge watchdog, checkpoint-resume,
elastic jobs.

The port's counterpart of paddle_tpu/resilience/, with the same names:

* :mod:`~paddle_tpu_torch.resilience.faults`: a deterministic, seeded
  fault-injection plane. A :class:`FaultPlan` arms named sites compiled
  into the hot paths (``executor.dispatch``, ``device_put``,
  ``rpc.send``, ``reader.next``, ``checkpoint.write``,
  ``trainer.heartbeat``, ``membership.join``) to raise, delay, wedge or
  SIGKILL on chosen occurrences, installed via context manager or
  ``PADDLE_TPU_FAULT_PLAN``.
* :mod:`~paddle_tpu_torch.resilience.watchdog`: heartbeat stamps from the
  executor's dispatches and host waits on the card, and a polling
  :class:`Watchdog` that tells a plan's first eager step and CUDA-graph
  capture from a wedged dispatch and escalates log, callback,
  kill-process-group.
* :mod:`~paddle_tpu_torch.resilience.supervisor`:
  :func:`resilient_train_loop`: periodic async checkpoints with an
  atomic manifest (latest-pointer, retain-last-K), jittered-backoff
  retry, and resume-from-latest that rebuilds the executor, reloads
  persistables and the RNG chain onto its device, and fast-forwards the
  reader, so a crashed-and-restarted run is bitwise identical to an
  uninterrupted one.
* :mod:`~paddle_tpu_torch.resilience.elastic`: the generation-based
  elastic job (:class:`ElasticJobSupervisor`) over the parameter-server
  path, its workers on the card unless the job asks for the CPU.
* :mod:`~paddle_tpu_torch.resilience.backoff`: the shared full-jitter
  exponential backoff.

Everything counts into the ``paddle_resilience_*`` and
``paddle_elastic_*`` observe families.
"""

from .backoff import backoff_delay, millis_env  # noqa: F401
from .elastic import (ElasticJobResult, ElasticJobSupervisor,  # noqa: F401
                      demo_builder, demo_feed)
from .faults import (FaultPlan, FaultSpec, InjectedFault,  # noqa: F401
                     active_plan, fault_point)
from .supervisor import (MANIFEST_NAME, SupervisorResult,  # noqa: F401
                         latest_checkpoint_dir, read_manifest,
                         resilient_train_loop, write_manifest)
from .watchdog import (Heartbeat, Watchdog, WedgeEvent,  # noqa: F401
                       heartbeat, run_with_deadline)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "fault_point",
    "active_plan",
    "Heartbeat", "Watchdog", "WedgeEvent", "heartbeat",
    "run_with_deadline",
    "resilient_train_loop", "SupervisorResult", "read_manifest",
    "write_manifest", "latest_checkpoint_dir", "MANIFEST_NAME",
    "ElasticJobSupervisor", "ElasticJobResult", "demo_builder",
    "demo_feed",
    "backoff_delay", "millis_env",
]
