"""Hierarchical span tracer: per-step phase timings + Chrome trace events
(counterpart of ``trlx_tpu/obs/spans.py``; a copy on the host clock, with
no device sync).

- ``with tracer.span("generate")`` times a phase on the calling thread.
  Spans nest: a per-thread stack builds dotted paths (``produce.generate``),
  so the same code timed from different contexts stays distinguishable.
- Durations accumulate into a per-path aggregate that a caller drains once
  per step (:meth:`drain_step_times`) as ``time/span/<path>`` stats.
- When ``trace_path`` is set, every span also becomes a Chrome-trace-event
  (``ph: "X"`` complete event, microsecond timestamps, real thread ids), so
  :meth:`write_trace` emits a ``trace.json`` that chrome://tracing and
  Perfetto load directly.
- With ``annotate_device=True`` each span also enters a
  ``torch.profiler.record_function`` range, so host spans appear as named
  ranges in a ``torch.profiler`` trace (the reference enters
  ``jax.profiler.TraceAnnotation``).

A disabled tracer (the default) short-circuits ``span()`` before taking any
lock or timestamp: the hot path costs one attribute check.

The process-global :data:`tracer` mirrors
:data:`trlx_tpu_torch.utils.metrics.gauges`: subsystems (the trainers, the
rollout producer, the checkpoint writer) call the module-level :func:`span`
without knowing who configured tracing; the
:class:`~trlx_tpu_torch.obs.runtime.Observability` runtime configures it
from ``train.observability`` and drains it once per step.
"""

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class SpanTracer:
    """Thread-safe hierarchical span timer (see module docstring)."""

    def __init__(
        self,
        enabled: bool = False,
        trace_path: Optional[str] = None,
        annotate_device: bool = False,
        max_events: int = 100_000,
    ):
        self.enabled = enabled
        self.trace_path = trace_path
        self.annotate_device = annotate_device
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._step_times: Dict[str, float] = {}
        self._step_counts: Dict[str, int] = {}
        self._events: List[Dict[str, Any]] = []
        self._dropped_events = 0
        self._thread_names: Dict[int, str] = {}
        # one origin for every thread's timestamps: trace events must share a clock
        self._epoch = time.perf_counter()

    def configure(
        self,
        enabled: bool,
        trace_path: Optional[str] = None,
        annotate_device: bool = False,
        max_events: int = 100_000,
    ):
        """Reconfigure in place (the global tracer outlives any one trainer)."""
        with self._lock:
            self.enabled = enabled
            self.trace_path = trace_path
            self.annotate_device = annotate_device
            self.max_events = int(max_events)

    # ------------------------------------------------------------------ spans

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a phase; nested calls build a dotted path per thread."""
        # lock-free read is the "flags off costs one attribute check" contract;
        # a configure() racing a span at worst mistimes that one span
        if not self.enabled:  # graftcheck: noqa[TH001,CC001] — the "flags off costs one attribute check" contract
            yield
            return
        stack = self._stack()
        stack.append(name)
        path = ".".join(stack)
        annot = contextlib.nullcontext()
        # lock-free like `enabled` above: a reconfigure racing span-open at
        # worst drops the profiler range for that one span
        if self.annotate_device:  # graftcheck: noqa[TH001,CC001] — lock-free like `enabled`
            import torch

            annot = torch.profiler.record_function(path)
        t0 = time.perf_counter()
        try:
            with annot:
                yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                self._step_times[path] = self._step_times.get(path, 0.0) + dur
                self._step_counts[path] = self._step_counts.get(path, 0) + 1
                if self.trace_path is not None:
                    if len(self._events) < self.max_events:
                        tid = threading.get_ident()
                        self._thread_names.setdefault(
                            tid, threading.current_thread().name
                        )
                        self._events.append(
                            {
                                "name": path,
                                "ph": "X",
                                "ts": (t0 - self._epoch) * 1e6,  # microseconds
                                "dur": dur * 1e6,
                                "pid": os.getpid(),
                                "tid": tid,
                                "cat": "host",
                            }
                        )
                    else:
                        self._dropped_events += 1

    # ----------------------------------------------------------------- export

    def drain_step_times(self, prefix: str = "time/span/") -> Dict[str, float]:
        """Return accumulated per-path seconds since the last drain and reset.

        Spans recorded on worker threads between two learner steps are drained
        with the later step — per-step attribution for the overlapped phases.
        Each path also drains its call count as ``<prefix><path>_n``, so
        per-call latency is computable from tracker stats (seconds / n).
        """
        with self._lock:
            out = {f"{prefix}{k}": v for k, v in self._step_times.items()}
            for k, n in self._step_counts.items():
                out[f"{prefix}{k}_n"] = float(n)
            self._step_times.clear()
            self._step_counts.clear()
        return out

    def write_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write accumulated events as Chrome trace-event JSON; returns the path
        (None when tracing was off or nothing was recorded)."""
        with self._lock:
            path = path or self.trace_path
            events = list(self._events)
            thread_names = dict(self._thread_names)
            dropped = self._dropped_events
        if path is None:
            return None
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": os.getpid(),
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in thread_names.items()
        ]
        doc: Dict[str, Any] = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if dropped:
            doc["metadata"] = {"dropped_events": dropped}
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    @property
    def epoch(self) -> float:
        """Timestamp origin every recorded event is relative to — external
        event producers (the flight recorder's per-uid async lanes) rebase
        onto this so merged events share the trace's clock."""
        with self._lock:
            return self._epoch

    def add_events(self, events: List[Dict[str, Any]]):
        """Merge externally produced Chrome trace events (the
        FlightRecorder's per-uid async lanes) into the event stream, under
        the same ``max_events`` bound as native spans."""
        with self._lock:
            room = max(0, self.max_events - len(self._events))
            self._events.extend(events[:room])
            self._dropped_events += max(0, len(events) - room)

    def reset(self):
        """Drop all accumulated state (tests / a fresh training run)."""
        with self._lock:
            self._step_times.clear()
            self._step_counts.clear()
            self._events.clear()
            self._thread_names.clear()
            self._dropped_events = 0
            self._epoch = time.perf_counter()


#: Process-global tracer; subsystems open spans, the trainer configures/drains.
tracer = SpanTracer()


def span(name: str):
    """``with span("generate"):`` against the process-global tracer."""
    return tracer.span(name)
