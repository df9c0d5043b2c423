"""Unified observability layer (counterpart of ``trlx_tpu/obs``): span
tracing, throughput/MFU accounting, device-memory gauges, a stall watchdog,
request flights and gauge time series with their exporters.

Each primitive is usable standalone; the :class:`Observability` facade binds
them to ``TRLConfig.train.observability`` and the trainer drives it once per
step:

- :mod:`~trlx_tpu_torch.obs.spans` — thread-safe hierarchical span tracer;
  ``with span("generate"):`` times phases across the learner and the rollout
  producer thread, exports per-step aggregates, and writes Chrome-trace-event
  JSON (``trace.json``, Perfetto-viewable).
- :mod:`~trlx_tpu_torch.obs.throughput` — tokens/sec, samples/sec, and MFU
  from param count + measured step time, against the card's data-sheet peak.
- :mod:`~trlx_tpu_torch.obs.memory` — device-memory gauges from the CUDA
  caching allocator (the host RSS on the CPU).
- :mod:`~trlx_tpu_torch.obs.watchdog` — heartbeat monitor that dumps all
  Python thread stacks when the learner or producer stops making progress,
  with per-heartbeat escalation (the producer supervisor's restart).
- :mod:`~trlx_tpu_torch.obs.flight` — per-uid request-flight journal reducing
  lifecycle events to a per-phase latency decomposition.
- :mod:`~trlx_tpu_torch.obs.timeseries` / :mod:`~trlx_tpu_torch.obs.export`
  — bounded gauge time-series with windowed reductions, plus atomic JSONL
  and Prometheus text exporters.

- :mod:`~trlx_tpu_torch.obs.overlap` — the busy-interval ledger of
  stream-overlapped PPO (decode time against the reward / score /
  learn-stage work that overlapped it).
- :mod:`~trlx_tpu_torch.obs.islands` — per-island idle-bubble ledgers of
  the generation / learner split (``train.islands``).

``train.profile_dir`` (a ``torch.profiler`` window over
``[profile_start_step, profile_end_step)``) lives in the trainer's loop.
"""

from trlx_tpu_torch.obs.export import (
    read_jsonl_series,
    read_prometheus,
    write_jsonl_series,
    write_prometheus,
)
from trlx_tpu_torch.obs.flight import Flight, FlightRecorder, flight
from trlx_tpu_torch.obs.islands import IslandLedger
from trlx_tpu_torch.obs.memory import device_memory_stats, host_rss_bytes
from trlx_tpu_torch.obs.overlap import OverlapWindow
from trlx_tpu_torch.obs.runtime import Observability, batch_token_count
from trlx_tpu_torch.obs.spans import SpanTracer, span, tracer
from trlx_tpu_torch.obs.throughput import (
    PEAK_TFLOPS_BY_DEVICE_KIND,
    ThroughputAccountant,
    detect_peak_tflops,
    param_count,
    transformer_flops_per_token,
)
from trlx_tpu_torch.obs.timeseries import SeriesStore
from trlx_tpu_torch.obs.watchdog import StallWatchdog, format_all_stacks, watchdog

__all__ = [
    "Flight",
    "FlightRecorder",
    "IslandLedger",
    "Observability",
    "OverlapWindow",
    "PEAK_TFLOPS_BY_DEVICE_KIND",
    "SeriesStore",
    "SpanTracer",
    "StallWatchdog",
    "ThroughputAccountant",
    "batch_token_count",
    "detect_peak_tflops",
    "device_memory_stats",
    "flight",
    "format_all_stacks",
    "host_rss_bytes",
    "param_count",
    "read_jsonl_series",
    "read_prometheus",
    "span",
    "tracer",
    "transformer_flops_per_token",
    "watchdog",
    "write_jsonl_series",
    "write_prometheus",
]
