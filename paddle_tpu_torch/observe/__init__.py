"""observe: process-wide runtime telemetry (metrics registry + trace
spans).

The port's counterpart of paddle_tpu/observe/, trimmed to what the pass
pipeline, the kernel tier, the Executor and its step loop move: the
metric registry (``metrics.py``), the well-known families
(``families.py``, the same names as the JAX package's), the trace spans
(``trace.py``), the timed spans with the feed-to-run gap stamp
(``spans.py``) and the time-series rings whose ``Ewma`` the serving
router smooths its token rate with (``timeseries.py``, not imported
here yet), the live ``/metrics`` and ``/healthz`` exporter
(``export.py``, its health read from the watchdog's heartbeat) and the
graceful-shutdown handlers that flush telemetry and stop the exporter
(``shutdown.py``). The fleet collector, the SLO monitor and the
Prometheus parser are not ported yet.

    from paddle_tpu_torch import observe

    observe.snapshot()            # JSON-able dict of every metric
    observe.get_metric("paddle_optimizer_programs_optimized_total")
"""

from __future__ import annotations

from . import families  # noqa: F401  (declares the well-known families)
from . import trace  # noqa: F401  (trace contexts + flight recorder)
from .export import (MetricsExporter, active_exporter,  # noqa: F401
                     default_instance, start_from_env, stop_exporter)
from .families import REGISTRY
from .metrics import (Counter, DEFAULT_BUCKETS, Family, Gauge,  # noqa: F401
                      Histogram, Registry, quantile_from_buckets)
from .shutdown import (install_shutdown_handlers,  # noqa: F401
                       uninstall_shutdown_handlers)
from .spans import (Span, mark_batch_produced,  # noqa: F401
                    observe_feed_gap, span)
from .trace import (FlightRecorder, TraceContext, attach,  # noqa: F401
                    current, dump_flight_recorder, export_chrome_trace,
                    new_trace, record_span, trace_enabled, trace_event,
                    trace_span)

__all__ = ["REGISTRY", "counter", "gauge", "histogram", "get_metric",
           "snapshot", "render_prometheus", "dump", "reset",
           "Counter", "Gauge", "Histogram", "Family", "Registry",
           "DEFAULT_BUCKETS", "quantile_from_buckets",
           "span", "Span", "mark_batch_produced", "observe_feed_gap",
           "TraceContext", "FlightRecorder", "trace_enabled", "new_trace",
           "current", "attach", "trace_span", "trace_event", "record_span",
           "dump_flight_recorder", "export_chrome_trace",
           "MetricsExporter", "active_exporter", "start_from_env",
           "stop_exporter", "default_instance",
           "install_shutdown_handlers", "uninstall_shutdown_handlers"]

# module-level facade over the process-wide registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
get_metric = REGISTRY.get
snapshot = REGISTRY.snapshot
render_prometheus = REGISTRY.render_prometheus
dump = REGISTRY.dump


def reset():
    """Zero every metric and the span state (the pending feed-to-run
    stamp, the flight-recorder ring, this thread's trace context): test
    isolation, not a runtime operation."""
    from . import spans as _spans

    REGISTRY.reset()
    _spans._clear_batch_stamp()
    trace._reset()
