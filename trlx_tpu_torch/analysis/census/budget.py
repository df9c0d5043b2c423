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

A mesh entry (``--mesh``: keyed ``name@<device>`` for an entry registered
with its own mesh, ``name@cpu:mesh`` on the reference's audit mesh) also
commits its ``mesh``, its ``collectives`` (the reference's IR005: the count
of each ``<kind>:<axes>`` exact, its bytes within
:data:`BYTES_TOLERANCE_PCT`, a key that appears or disappears a
violation), its ``staged`` calls and bytes and its ``state_bytes`` (exact),
and ``peak_bytes`` per rank (each within the memory band).
"""

import json
from pathlib import Path
from typing import Any, Dict, List

from trlx_tpu_torch.analysis.census import seeds

DEFAULT_BUDGET = Path(__file__).resolve().parent / "budget.json"

MEMORY_TOLERANCE_PCT = 10.0
#: the reference's collective-bytes headroom (``trlx_tpu/analysis/ir/budget.py``)
BYTES_TOLERANCE_PCT = 10.0
EXACT = ("ops", "heavy_f32", "round_trips", "warmup_shapes", "launches", "syncs", "kernel_launches")
#: what an entry commits; the rest of a measurement (memcpys, launches per API) is diagnostics
COMMITTED = EXACT + ("steady_new_shapes", "peak_bytes")
#: what a mesh entry commits besides, exact
MESH_EXACT = ("mesh", "staged", "state_bytes")
MESH_COMMITTED = MESH_EXACT + ("collectives",)


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
        "_regenerate": "python -m trlx_tpu_torch.analysis.census --device {cpu,cuda} [--mesh] --write-budget",
        "_tolerances": {"memory_pct": MEMORY_TOLERANCE_PCT, "collective_bytes_pct": BYTES_TOLERANCE_PCT},
    }
    entries = dict(keep or {})
    for key, m in measurements.items():
        entry = {f: m[f] for f in COMMITTED + (MESH_COMMITTED if "mesh" in m else ()) if f in m}
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
        for field in ("ops", "heavy_f32", "round_trips", "kernel_launches", "launches", "syncs", "collectives",
                      "staged"):
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
        for field in EXACT + MESH_EXACT:
            if field in want and got.get(field) != want[field]:
                violations.append(f"{key}: {field} {want[field]} -> {got.get(field)}")
        if isinstance(got.get("collectives"), dict):
            violations += _compare_collectives(key, got["collectives"], want.get("collectives", {}))
        g, w = got.get("peak_bytes"), want.get("peak_bytes")
        if g is not None and w is not None:
            gs, ws = (g, w) if isinstance(w, list) else ([g], [w])
            if not isinstance(gs, list) or len(gs) != len(ws):
                violations.append(f"{key}: peak_bytes {w} -> {g} (another rank count)")
            for rank, (g, w) in enumerate(zip(gs, ws) if isinstance(gs, list) else ()):
                if _beyond(g, w, MEMORY_TOLERANCE_PCT):
                    where = f" on rank {rank}" if isinstance(want["peak_bytes"], list) else ""
                    violations.append(f"{key}: peak_bytes{where} {w} -> {g} ({100.0 * (g - w) / max(w, 1):+.1f}% "
                                      f"beyond ±{MEMORY_TOLERANCE_PCT:g}%)")
    return violations


def _beyond(got: int, want: int, pct: float) -> bool:
    return abs(got - want) > max(want, 1) * pct / 100.0


def _compare_collectives(key: str, got: Dict[str, Dict[str, int]], want: Dict[str, Dict[str, int]]) -> List[str]:
    """The reference's IR005 over one entry's ``<kind>:<axes>`` table."""
    out = []
    for ck in sorted(set(got) | set(want)):
        g, w = got.get(ck), want.get(ck)
        if w is None:
            out.append(f"{key}: NEW collective {ck} x{g['count']} ({g['bytes']} B/step) not in the committed budget")
        elif g is None:
            out.append(f"{key}: budgeted collective {ck} x{w['count']} no longer issued (regenerate to lock it in)")
        else:
            if g["count"] != w["count"]:
                out.append(f"{key}: collective {ck} count {w['count']} -> {g['count']}")
            if _beyond(g["bytes"], w["bytes"], BYTES_TOLERANCE_PCT):
                out.append(f"{key}: collective {ck} bytes {w['bytes']} -> {g['bytes']} "
                           f"(beyond ±{BYTES_TOLERANCE_PCT:g}%)")
    return out
