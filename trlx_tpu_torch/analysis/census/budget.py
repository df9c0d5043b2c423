"""The committed census budget: ``budget.json`` beside this module.

One entry per registered hot entrypoint and device, keyed ``name@cpu``
(the tiny seeded configuration the CPU census runs) or ``name@cuda``
(gpt2's published widths on the card). Counts are exact: aten ops, heavy
f32 ops, host round-trips, warmup shape signatures, and on the card device
kernel launches, synchronizing runtime calls and hand-written kernel
launches. ``steady_new_shapes`` is pinned at 0 whatever the file says (the
reference's steady-compile rule, ``trlx_tpu/analysis/rt/budget.py``), and
``peak_bytes`` may move within ±10 % (``trlx_tpu/analysis/ir/budget.py``'s
memory headroom). Deviations are failures: the only way to new numbers is
``python -m trlx_tpu_torch.analysis.census --write-budget`` and a committed
diff.
"""

import json
from pathlib import Path
from typing import Any, Dict, List

from trlx_tpu_torch.analysis.census import seeds

DEFAULT_BUDGET = Path(__file__).resolve().parent / "budget.json"

MEMORY_TOLERANCE_PCT = 10.0
EXACT = ("ops", "heavy_f32", "round_trips", "warmup_shapes", "launches", "syncs", "kernel_launches")
#: what an entry commits; the rest of a measurement (memcpys, launches per API) is diagnostics
COMMITTED = EXACT + ("steady_new_shapes", "peak_bytes")


def load(path=DEFAULT_BUDGET) -> Dict[str, Any]:
    p = Path(path)
    if not p.exists():
        return {}
    return {k: v for k, v in json.loads(p.read_text()).items() if not k.startswith("_")}


def write(path, measurements: Dict[str, Dict[str, Any]], keep: Dict[str, Any] = None) -> int:
    """Write ``measurements`` (keyed ``name@device``) over the entries of
    ``keep`` (the committed file: the other device's entries stay).
    Refuses under a seeded regression."""
    if seeds.active():
        raise RuntimeError(f"refusing --write-budget while {seeds.ENV_VAR}={seeds.active()!r} is set: "
                           f"the seeded defect would be committed as the expected census")
    doc: Dict[str, Any] = {
        "_format": ("per-entrypoint census, keyed name@device: counts exact, steady_new_shapes pinned at 0, "
                    "peak_bytes within the tolerance (trlx_tpu_torch/analysis/census/budget.py)"),
        "_regenerate": "python -m trlx_tpu_torch.analysis.census --device {cpu,cuda} --write-budget",
        "_tolerances": {"memory_pct": MEMORY_TOLERANCE_PCT},
    }
    entries = dict(keep or {})
    for key, m in measurements.items():
        entry = {f: m[f] for f in COMMITTED if f in m}
        entry["steady_new_shapes"] = 0  # the contract, not the measurement
        entries[key] = entry
    for key in sorted(entries):
        doc[key] = entries[key]
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")
    return len(measurements)


def compare(measurements: Dict[str, Dict[str, Any]], budget: Dict[str, Any]) -> List[str]:
    """The violations of fresh measurements against the budget."""
    violations: List[str] = []
    for key in sorted(measurements):
        got, want = measurements[key], budget.get(key)
        if got.get("steady_new_shapes", 0) != 0:
            violations.append(f"{key}: steady state dispatched {got['steady_new_shapes']} shape signature(s) "
                              f"the warmup never did (a CUDA-graph capture of the warmup would miss them)")
        for field in ("ops", "heavy_f32", "round_trips", "kernel_launches", "launches", "syncs"):
            if isinstance(got.get(field), list):
                violations.append(f"{key}: {field} differs between steady steps: {got[field]}")
        if got.get("graph_launches"):
            violations.append(f"{key}: {got['graph_launches']} CUDA-graph launch(es) a step, whose kernels "
                              f"the launch count does not see")
        if "syncs" in got and got["syncs"] != got.get("round_trips"):
            violations.append(f"{key}: {got['syncs']} synchronizing runtime calls but the census counts "
                              f"{got.get('round_trips')} host round-trips")
        if want is None:
            violations.append(f"{key}: no committed budget entry — run --write-budget and commit the result")
            continue
        for field in EXACT:
            if field in want and got.get(field) != want[field]:
                violations.append(f"{key}: {field} {want[field]} -> {got.get(field)}")
        g, w = got.get("peak_bytes"), want.get("peak_bytes")
        if g is not None and w is not None and abs(g - w) > max(w, 1) * MEMORY_TOLERANCE_PCT / 100.0:
            violations.append(f"{key}: peak_bytes {w} -> {g} ({100.0 * (g - w) / max(w, 1):+.1f}% beyond "
                              f"±{MEMORY_TOLERANCE_PCT:g}%)")
    return violations
