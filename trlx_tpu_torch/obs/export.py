"""Series/gauge exporters: atomic JSONL dumps + Prometheus text exposition
(counterpart of ``trlx_tpu/obs/export.py``, a copy: the files are byte for
byte the JAX package's).

Two formats, one atomicity discipline (write to a same-directory temp file,
``os.replace`` into place — a scraper or tail never sees a torn file):

- **JSONL series dump** — one line per key: ``{"key": ..., "points":
  [[t, v], ...]}``. The full retained window of every
  :class:`~trlx_tpu_torch.obs.timeseries.SeriesStore` ring, loadable with
  :func:`read_jsonl_series` for offline analysis (the round-trip is exact).
- **Prometheus text exposition** — the current value of every gauge as one
  ``trlx_gauge{key="..."}`` sample. The raw registry key rides as a label
  (escaped per the exposition format), so :func:`read_prometheus` recovers
  the exact key set; a real Prometheus scrape of the same file works
  unmodified (``# TYPE trlx_gauge gauge``).

Both writers are plain functions over plain data — no background thread,
no network; the :class:`~trlx_tpu_torch.obs.runtime.Observability` facade
calls them on close.
"""

import json
import os
import re
import tempfile
from typing import Dict, List, Mapping, Optional, Tuple

from trlx_tpu_torch.obs.timeseries import SeriesStore
from trlx_tpu_torch.utils.metrics import gauges

#: single metric family: every gauge is one labeled sample of it
PROM_METRIC = "trlx_gauge"

_LABEL_UNESCAPE = {"\\\\": "\\", '\\"': '"', "\\n": "\n"}
_PROM_LINE = re.compile(
    rf'^{PROM_METRIC}\{{key="((?:[^"\\]|\\.)*)"\}} (\S+)$'
)


def _atomic_write(path: str, text: str) -> str:
    """Write ``text`` to ``path`` atomically (temp file + rename in the same
    directory — rename across filesystems would not be atomic)."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


# ----------------------------------------------------------------- JSONL


def write_jsonl_series(store: SeriesStore, path: str, prefix: str = "") -> str:
    """Dump every retained series under ``prefix`` as JSONL, atomically."""
    lines = []
    for key in store.keys(prefix):
        points = [[t, v] for t, v in store.series(key)]
        lines.append(json.dumps({"key": key, "points": points}))
    return _atomic_write(path, "\n".join(lines) + ("\n" if lines else ""))


def read_jsonl_series(path: str) -> Dict[str, List[Tuple[float, float]]]:
    """Load a JSONL series dump back into ``{key: [(t, v), ...]}``."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            out[doc["key"]] = [(float(t), float(v)) for t, v in doc["points"]]
    return out


# ------------------------------------------------------------- Prometheus


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape_label(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        two = value[i : i + 2]
        if two in _LABEL_UNESCAPE:
            out.append(_LABEL_UNESCAPE[two])
            i += 2
        else:
            out.append(value[i])
            i += 1
    return "".join(out)


def write_prometheus(
    path: str,
    values: Optional[Mapping[str, float]] = None,
    prefix: str = "",
) -> str:
    """Write the current gauges (or an explicit ``values`` mapping) in
    Prometheus text exposition format, atomically. Keys become the ``key``
    label of one ``trlx_gauge`` family — scrape-ready and exactly
    recoverable by :func:`read_prometheus`."""
    if values is None:
        values = gauges.snapshot(prefix)
    # the JAX package's HELP text, kept so both packages write the same bytes
    lines = [
        f"# HELP {PROM_METRIC} trlx_tpu runtime gauge (key label = registry name)",
        f"# TYPE {PROM_METRIC} gauge",
    ]
    for key in sorted(values):
        lines.append(
            f'{PROM_METRIC}{{key="{_escape_label(key)}"}} {repr(float(values[key]))}'
        )
    return _atomic_write(path, "\n".join(lines) + "\n")


def read_prometheus(path: str) -> Dict[str, float]:
    """Parse a :func:`write_prometheus` exposition back to ``{key: value}``."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = _PROM_LINE.match(line)
            if m is None:
                raise ValueError(f"unparseable exposition line: {line!r}")
            out[_unescape_label(m.group(1))] = float(m.group(2))
    return out
