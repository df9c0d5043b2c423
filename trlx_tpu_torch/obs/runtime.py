"""Observability runtime: one facade the trainer drives once per step
(counterpart of ``trlx_tpu/obs/runtime.py``).

:class:`Observability` binds the obs primitives (span tracer, throughput/MFU
accountant, device-memory sampler, stall watchdog, flight recorder, series
store — each usable standalone) to ``TRLConfig.train.observability``:

- ``__init__`` configures the process-global tracer and flight recorder and
  installs the global watchdog, so subsystems that only know the
  module-level ``span()`` / ``watchdog.beat()`` / ``flight.record()`` (the
  rollout producer, the serving engine) feed the same run.
- :meth:`configure_model` snapshots what MFU needs (parameter count and the
  peak FLOP/s of the trainer's one device) once the model exists.
- :meth:`step_stats` is the per-step drain: span timings, tokens/sec + MFU,
  step-time histogram percentiles, device-memory gauges, flight
  percentiles, one series sample — one flat dict merged into the stats the
  tracker logs.
- :meth:`close` writes ``trace.json`` and the series exports and
  stops/uninstalls the watchdog; it is idempotent and safe to call from
  ``learn()``'s finally.

When ``observability.enabled`` is False everything here short-circuits:
``step_stats`` returns ``{}``, the tracer and the flight recorder stay
disabled (a span or a flight site costs one attribute check), and no
watchdog thread exists — per-step stats are exactly the ones without the
layer. On or off, nothing here waits on the device: spans are host-clock
intervals, and the trainer closes each one after the host fetch that ends
its phase.
"""

import os
import time
from typing import Any, Dict, Optional

from trlx_tpu_torch.obs.flight import flight as global_flight
from trlx_tpu_torch.obs.memory import device_memory_stats
from trlx_tpu_torch.obs.spans import tracer as global_tracer
from trlx_tpu_torch.obs.throughput import (
    ThroughputAccountant,
    detect_peak_tflops,
    param_count,
)
from trlx_tpu_torch.obs.timeseries import SeriesStore
from trlx_tpu_torch.obs.watchdog import StallWatchdog
from trlx_tpu_torch.obs.watchdog import watchdog as global_watchdog
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


def device_kind(device) -> str:
    """The name MFU's peak is looked up by: ``torch.cuda.get_device_name``
    for a CUDA device, the device type otherwise."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class Observability:
    """Configured obs layer for one training run (see module docstring).
    ``device`` is the trainer's device: memory gauges read it and MFU's peak
    is detected from it."""

    def __init__(self, cfg, logging_dir: Optional[str] = None, *, device):
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self.device = device
        self.tracer = global_tracer
        self.flight = global_flight
        self.accountant: Optional[ThroughputAccountant] = None
        self.watchdog: Optional[StallWatchdog] = None
        self.series: Optional[SeriesStore] = None
        self._series_path: Optional[str] = None
        self._prom_path: Optional[str] = None
        self._step_count = 0
        self._last_step_end: Optional[float] = None
        self._closed = False
        if not self.enabled:
            return
        trace_path = cfg.trace_path
        if trace_path and not os.path.isabs(trace_path) and logging_dir:
            trace_path = os.path.join(logging_dir, trace_path)
        self.tracer.reset()
        self.tracer.configure(
            enabled=True,
            trace_path=trace_path,
            annotate_device=cfg.trace_device,
            max_events=cfg.max_trace_events,
        )
        if cfg.flight:
            self.flight.reset()
            self.flight.configure(enabled=True, ring=cfg.flight_ring, reservoir=cfg.flight_reservoir)
        self.series = SeriesStore(capacity=int(cfg.series_capacity))
        for name, attr in (("series_path", "_series_path"), ("prom_path", "_prom_path")):
            p = getattr(cfg, name)
            if p and not os.path.isabs(p) and logging_dir:
                p = os.path.join(logging_dir, p)
            setattr(self, attr, p)
        if cfg.watchdog_timeout_s > 0:
            self.watchdog = StallWatchdog(cfg.watchdog_timeout_s, poll_s=cfg.watchdog_poll_s)
            global_watchdog.install(self.watchdog)
            self.watchdog.start()

    # ------------------------------------------------------------------ model

    def configure_model(self, params: Any, model_config: Any = None):
        """Size the MFU denominator from the live model (a module or a
        mapping of tensors) and the trainer's device; called once when
        learning starts."""
        if not self.enabled or not self.cfg.mfu:
            return
        kind = device_kind(self.device)
        peak = self.cfg.peak_device_tflops
        if peak is None:
            peak = detect_peak_tflops(kind)
        self.accountant = ThroughputAccountant(
            param_count(params),
            num_devices=1,
            peak_device_tflops=peak,
            num_layers=getattr(model_config, "num_layers", 0) or 0,
            hidden_size=getattr(model_config, "hidden_size", 0) or 0,
        )
        if peak is None:
            logger.info(
                f"MFU denominator unknown for device {kind!r}: reporting model TFLOP/s "
                "only (set train.observability.peak_device_tflops to enable mfu)"
            )

    # ------------------------------------------------------------------- step

    def span(self, name: str):
        return self.tracer.span(name)

    def beat(self, name: str = "learner"):
        if self.watchdog is not None:
            self.watchdog.beat(name)

    def step_stats(self, tokens: int, samples: int, seq_len: int = 0) -> Dict[str, float]:
        """Per-step obs stats: span timings, throughput/MFU over the wall time
        since the previous call, step-time percentiles, memory gauges."""
        if not self.enabled:
            return {}
        now = time.monotonic()
        step_time = None if self._last_step_end is None else now - self._last_step_end
        self._last_step_end = now
        self._step_count += 1
        stats = self.tracer.drain_step_times()
        if step_time is not None:
            stats["time/step"] = step_time
            gauges.observe("time/step", step_time)
            stats.update(gauges.hist_snapshot("time/step"))
            if self.accountant is not None:
                stats.update(self.accountant.step_stats(tokens, samples, step_time, seq_len=seq_len))
        interval = self.cfg.memory_interval
        if interval and self._step_count % interval == 0:
            stats.update(device_memory_stats(self.device))
        # flight percentiles refresh before the obs/ snapshot so the
        # per-tenant phase gauges ride the same per-step export
        self.flight.export_gauges()
        stats.update(gauges.snapshot("obs/"))
        # resilience gauges (retry counts, inflight checkpoint writes, commit
        # latency) ride the same per-step export to every tracker backend
        stats.update(gauges.snapshot("resilience/"))
        if self.series is not None:
            # one sample of every gauge per step — the exporters dump these
            # rings on close
            self.series.sample()
        return stats

    # -------------------------------------------------------------- lifecycle

    def close(self):
        """Write the trace file and the series exports, and tear down the
        watchdog (idempotent)."""
        if not self.enabled or self._closed:
            return
        self._closed = True
        if self.watchdog is not None:
            global_watchdog.install(None)  # also stops it
            self.watchdog = None
        if self.series is not None:
            from trlx_tpu_torch.obs.export import write_jsonl_series, write_prometheus

            try:
                if self._series_path:
                    p = write_jsonl_series(self.series, self._series_path)
                    logger.info(f"wrote gauge time-series to {p}")
                if self._prom_path:
                    p = write_prometheus(self._prom_path)
                    logger.info(f"wrote Prometheus exposition to {p}")
            except OSError as e:
                logger.warning(f"could not write series exports: {e}")
        try:
            if self.flight.enabled and self.tracer.trace_path is not None:
                # merge per-uid flight lanes into the span trace: one request
                # reads as one async lane next to the host spans in Perfetto
                self.tracer.add_events(self.flight.trace_events(epoch=self.tracer.epoch))
            path = self.tracer.write_trace()
            if path:
                logger.info(f"wrote span trace to {path} (chrome://tracing / Perfetto)")
        except OSError as e:
            logger.warning(f"could not write span trace: {e}")
        self.tracer.configure(enabled=False)
        self.flight.configure(enabled=False)


def _host(x) -> Any:
    """A host numpy view of a numpy array or a torch tensor (a copy for a
    device tensor; the trainers' loop batches are host arrays)."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batch_token_count(batch: Any) -> tuple:
    """Best-effort (tokens, samples, seq_len) for a train batch — works for
    PPORLBatch (query+response masks), dict or dataclass batches with
    attention_mask, and falls back to dense input_ids shapes. Fields may be
    numpy arrays or torch tensors."""
    attn = getattr(batch, "attention_mask", None)
    resp = getattr(batch, "response_mask", None)
    if attn is None and isinstance(batch, dict):
        attn = batch.get("attention_mask")
        resp = batch.get("response_mask")
    if attn is not None:
        attn = _host(attn)
        tokens, seq_len = int(attn.sum()), int(attn.shape[1])
        if resp is not None:
            resp = _host(resp)
            tokens, seq_len = tokens + int(resp.sum()), seq_len + int(resp.shape[1])
        return tokens, int(attn.shape[0]), seq_len
    ids = batch.get("input_ids") if isinstance(batch, dict) else getattr(batch, "input_ids", None)
    if ids is not None:
        arr = _host(ids) if not isinstance(ids, list) else None
        if arr is not None and arr.ndim >= 2:
            return int(arr.size), int(arr.shape[0]), int(arr.shape[1])
        if isinstance(ids, list):
            return sum(len(p) for p in ids), len(ids), max((len(p) for p in ids), default=0)
    return 0, 0, 0
