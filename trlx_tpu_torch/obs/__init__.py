"""The two observability pieces the resilience layer needs (counterpart of
part of ``trlx_tpu/obs``): the span tracer and the stall watchdog. The rest
of the JAX package's ``obs/`` (the ``Observability`` runtime, throughput
and MFU, memory gauges, flights, ``profile_dir``) comes with the
observability slice."""

from trlx_tpu_torch.obs.spans import SpanTracer, span, tracer
from trlx_tpu_torch.obs.watchdog import StallWatchdog, format_all_stacks, watchdog

__all__ = ["SpanTracer", "StallWatchdog", "format_all_stacks", "span", "tracer", "watchdog"]
