"""``python -m trlx_tpu_torch.analysis.census``: run the census of every
registered hot entrypoint and hold it to the committed budget.

Usage::

    python -m trlx_tpu_torch.analysis.census [--device cuda|cpu] [--size xl | --mesh]
        [--entries decode_step,ppo_train_step] [--write-budget] [--budget FILE] [--json OUT]

``--device`` defaults to the card (``cuda``: gpt2's published widths,
budget keys ``name@cuda``), as the port's entry points do; ``--device cpu``
runs the tiny configuration on the CPU (keys ``name@cpu``). ``--size xl``
(the card only) runs ``decode_step`` and ``spec_verify_step`` at the
reference's GPT-2-XL blueprints over stacked layers (keys
``name@cuda:xl``). ``--mesh`` runs the mesh entries instead, one process
per rank (:mod:`~trlx_tpu_torch.analysis.census.ranks`): the two
``data=2 x fsdp=2`` learner steps (keys ``name@<device>``) and, on the CPU,
the trainers' entries on the reference's audit mesh ``data=2 x fsdp=2 x
model=2`` (keys ``name@cpu:mesh``); their ranks must count alike. Exit 1 on
any violation (and so under a seeded regression the gate catches), 2 on a
usage error or without a card for ``--device cuda``.
"""

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from trlx_tpu_torch.analysis.census import budget as budget_mod


#: the configuration each device runs (analysis/census/fixtures.py)
SIZES = {"cpu": "tiny", "cuda": "full"}


def run_census(device: str = "cpu", names: Optional[List[str]] = None,
               verbose: bool = False, shared: Optional[Dict] = None, size: Optional[str] = None) -> Dict[str, Dict]:
    """Build and measure each selected entry; ``{budget key: census}``.
    Entries share trainers and engines through one memo (``shared``: the
    caller's to keep and drop; by default a fresh one, dropped at the end).
    ``size="xl"`` measures :data:`~trlx_tpu_torch.analysis.census.fixtures.XL_ENTRIES`
    on the card, keyed ``name@cuda:xl``."""
    import torch

    from trlx_tpu_torch.analysis.census.entrypoints import load_all
    from trlx_tpu_torch.analysis.census.fixtures import XL_ENTRIES
    from trlx_tpu_torch.analysis.census.measure import measure

    dev = torch.device(device)
    suffix = ""
    if size == "xl":
        if dev.type != "cuda":
            raise ValueError("--size xl runs on the card only")
        suffix = ":xl"
        unknown = [n for n in names or () if n not in XL_ENTRIES]
        if unknown:
            raise ValueError(f"no xl size for {unknown}; xl entries: {list(XL_ENTRIES)}")
        names = list(names or XL_ENTRIES)
    elif size is not None:
        raise ValueError(f"unknown size {size!r}")
    size = size or SIZES[dev.type]
    registry = load_all()
    selected = list(names) if names else [n for n, ep in registry.items() if ep.mesh is None]
    unknown = [n for n in selected if n not in registry]
    if unknown:
        raise ValueError(f"unknown entrypoint(s) {unknown}; known: {list(registry)}")
    on_mesh = [n for n in selected if registry[n].mesh is not None]
    if on_mesh:
        raise ValueError(f"{on_mesh} run on a mesh only: pass --mesh")
    own = shared is None
    shared = {} if own else shared
    out: Dict[str, Dict] = {}
    try:
        for name in selected:
            t0 = time.perf_counter()
            entry = registry[name].factory(dev, size, shared)
            m = measure(entry, dev)
            out[f"{name}@{dev.type}{suffix}"] = m
            if verbose:
                print(f"[census] {name}: {json.dumps(m)} ({time.perf_counter() - t0:.1f}s)", flush=True)
    finally:
        if own:
            shared.clear()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def run_mesh_census(device: str = "cpu", names: Optional[List[str]] = None, verbose: bool = False,
                    seeded: Sequence[Tuple[str, str]] = ()) -> Tuple[Dict[str, Dict], Dict[str, Dict[str, Dict]]]:
    """The mesh census (see the module docstring): ``(measurements,
    seeded)``, each ``{budget key: census}`` merged over the ranks
    (:func:`~trlx_tpu_torch.analysis.census.ranks.merge`); ``seeded`` lists
    ``(entry name, seed)`` pairs measured after the clean entries in the
    same rank group, and the second result maps each seed to its censuses.
    Raises :class:`~trlx_tpu_torch.analysis.census.ranks.RanksDiffer` when
    the ranks count apart, RuntimeError when a rank fails."""
    import torch

    from trlx_tpu_torch.analysis.census import ranks
    from trlx_tpu_torch.analysis.census.entrypoints import load_all, mesh_runs

    dev = torch.device(device)
    registry = load_all()
    runs = mesh_runs(registry, dev.type)
    known = {n for entries in runs.values() for n, _ in entries}
    unknown = [n for n in list(names or ()) + [n for n, _ in seeded] if n not in known]
    if unknown:
        raise ValueError(f"no mesh entry {unknown} on {dev.type}; mesh entries: {sorted(known)}")
    if dev.type == "cuda":
        from trlx_tpu_torch.analysis.census import api_counter
        from trlx_tpu_torch.ops import _kernels

        _kernels.build()  # once here, not in every rank
        api_counter.counter_library()
    measured: Dict[str, Dict] = {}
    by_seed: Dict[str, Dict[str, Dict]] = {}
    for shape, entries in runs.items():
        mesh = dict(zip(("data", "fsdp", "pipe", "model"), shape))
        jobs = [(n, sfx, None) for n, sfx in entries if not names or n in names]
        jobs += [(n, sfx, seed) for n, sfx in entries for name, seed in seeded if name == n]
        if not jobs:
            continue
        t0 = time.perf_counter()
        merged = ranks.merge(ranks.run_group(mesh, jobs, device, SIZES[dev.type]), mesh)
        for key, m in merged.items():
            if "#" in key:
                key, seed = key.split("#")
                by_seed.setdefault(seed, {})[key] = m
            else:
                measured[key] = m
            if verbose:
                print(f"[census] {key}: {json.dumps(m)}", flush=True)
        if verbose:
            print(f"[census] mesh {mesh}: {len(jobs)} entries on {math.prod(shape)} ranks "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return measured, by_seed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trlx_tpu_torch.analysis.census", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", default=None, choices=["xl"],
                    help="xl: decode_step and spec_verify_step at GPT-2-XL over stacked layers (the card only)")
    ap.add_argument("--mesh", action="store_true",
                    help="the mesh entries, one process per rank (see the module docstring)")
    ap.add_argument("--entries", default=None, help="comma-separated entrypoint names (default: all)")
    ap.add_argument("--budget", default=str(budget_mod.DEFAULT_BUDGET))
    ap.add_argument("--write-budget", action="store_true")
    ap.add_argument("--json", default=None, help="also write the measurements to this file")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("census: no CUDA device; pass --device cpu for the CPU census", file=sys.stderr)
        return 2
    names = [n.strip() for n in args.entries.split(",") if n.strip()] if args.entries else None
    if args.mesh and args.size:
        print("census: --mesh runs the mesh entries at the device's size; drop --size", file=sys.stderr)
        return 2
    try:
        if args.mesh:
            measurements, _ = run_mesh_census(args.device, names, verbose=True)
        else:
            measurements = run_census(args.device, names, verbose=True, size=args.size)
    except ValueError as e:
        print(f"census: {e}", file=sys.stderr)
        return 2
    if args.json:
        with open(args.json, "w") as f:
            json.dump(measurements, f, indent=1)
    if args.write_budget:
        n = budget_mod.write(args.budget, measurements, keep=budget_mod.load(args.budget))
        print(f"census: wrote {n} budget entries to {args.budget}")
        return 0
    violations = budget_mod.compare(measurements, budget_mod.load(args.budget))
    for line in violations:
        print(f"census: VIOLATION {line}")
    print(f"census: {len(measurements)} entr{'y' if len(measurements) == 1 else 'ies'}, "
          f"{len(violations)} violation(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
