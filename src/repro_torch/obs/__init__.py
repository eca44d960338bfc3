"""repro_torch.obs: tracing + metrics for the whole request path.

Three pieces, one import surface:

  ``span`` / ``Tracer``      begin/end spans on ``time.perf_counter``
                             from ``Engine.submit`` through the shard's
                             LSM tree and GLORAN index down to kernel
                             dispatch, exported as Chrome trace-event
                             JSON (loads in Perfetto with one track per
                             shard worker thread).  A process-global
                             no-op tracer is the default — the off
                             switch costs nothing measurable (env
                             ``REPRO_TRACE=1`` turns recording on),
  ``LatencyHistogram``       fixed log-scale buckets feeding p50/p95/p99
                             per op class and per shard into
                             ``engine.stats()``,
  ``MetricsRegistry``        counters/gauges from every subsystem under
                             one dot-namespaced flat snapshot schema.

See README.md beside this file for the spans, GLORAN's counters and
the metric namespace.
"""

from .hist import LatencyHistogram
from .metrics import MetricsRegistry
from .tracer import (NULL_TRACER, NullTracer, Tracer, enabled, get_tracer,
                     set_tracer, span, tracing_enabled)

__all__ = ["LatencyHistogram", "MetricsRegistry", "NULL_TRACER",
           "NullTracer", "Tracer", "enabled", "get_tracer", "set_tracer",
           "span", "tracing_enabled"]
