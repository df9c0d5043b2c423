"""Registry of the port's hot entrypoints: the steps the census measures.

A *hot entrypoint* is one of the handful of steps a run spends its time in:
the rollout decode, the serving engine's device programs, the learner
steps, the streamed scoring bucket. Each registers a **factory** next to the
code it measures (``ops/generation.py``, ``serving/engine.py``,
``methods/{ppo,grpo,ilql}.py``, ``trainer/ppo_trainer.py``) with
:func:`register_entrypoint`, the counterpart of the reference's
``trlx_tpu/analysis/ir/entrypoints.py``.

``factory(device, size, shared) -> Entry`` sets the step up at a fixed,
seeded shape with greedy decoding (``size`` is ``"tiny"`` for the CPU
census, ``"full"`` for gpt2's published widths on the card; ``shared``
memoizes trainers and engines across factories) and returns an
:class:`Entry` whose ``step(k)`` runs one step on content variant ``k``:
the ``warmup`` variants first, then ``steady`` ones that differ in content
but not in bucketed shape.

The registration also carries what the static rule TX002 reads from the
AST (:mod:`trlx_tpu_torch.analysis.rules_torch`): ``roots``, the dotted
qualified names of the functions one step runs, and ``readback``, the host
round-trips each of them makes per call by design.

On a mesh (``python -m trlx_tpu_torch.analysis.census --mesh``, one process
per rank: :mod:`~trlx_tpu_torch.analysis.census.ranks`) the census runs two
kinds of entry. An entry registered with ``mesh=`` (the
``data=2 x fsdp=2`` learner steps ``ppo_train_step_overlap`` and
``ppo_train_step_unsharded_opt``, as the reference registers them) runs on
that mesh only, keyed ``name@<device>``. The entries of
:data:`ON_AUDIT_MESH` run on the CPU on :data:`DEFAULT_AUDIT_MESH` as well,
keyed ``name@cpu:mesh``: the trainers' steps among the entries the reference
audits there (:data:`REFERENCE_AUDITED`). The serving engine's entries stay
on one device: in both packages a trainer on a mesh of more than one rank
leaves its engine off, with the reference's warning. The factories read
the mesh from ``shared["mesh"]`` (:func:`~trlx_tpu_torch.analysis.census.
fixtures.trainer`).

Import-light on purpose: registering modules import it at module scope.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

#: the mesh the reference audits every entry on unless it names its own
#: (``trlx_tpu/analysis/ir/entrypoints.py:30``, ``DEFAULT_AUDIT_MESH``)
DEFAULT_AUDIT_MESH = {"data": 2, "fsdp": 2, "pipe": 1, "model": 2}
#: the entries the reference audits on :data:`DEFAULT_AUDIT_MESH`
REFERENCE_AUDITED = ("decode_step", "paged_decode_step", "spec_verify_step", "ppo_train_step", "grpo_train_step",
                     "ilql_train_step")
#: of those, the ones the port's census runs there (the trainers run them
#: on a mesh; the engine's ``paged_decode_step`` and ``spec_verify_step``
#: stay on one device)
ON_AUDIT_MESH = ("decode_step", "ppo_train_step", "grpo_train_step", "ilql_train_step")


@dataclass
class Entry:
    """What a factory returns."""

    step: Callable[[int], Any]  #: one step on content variant k
    warmup: Sequence[int] = (0,)
    steady: Sequence[int] = (1, 2)
    #: the optimizer whose state the census counts (``state_bytes``), if any
    optimizer: Any = None


@dataclass
class EntryPoint:
    name: str
    factory: Callable[..., Entry]
    roots: Tuple[str, ...]
    readback: Dict[str, int]
    #: the mesh shape the entry runs on only (None: one device, or
    #: :data:`DEFAULT_AUDIT_MESH` for the entries of :data:`ON_AUDIT_MESH`)
    mesh: Optional[Dict[str, int]] = None


#: name -> EntryPoint; populated by :func:`register_entrypoint` at import time
ENTRYPOINTS: Dict[str, EntryPoint] = {}


def register_entrypoint(name: str, *, roots: Sequence[str] = (), readback: Dict[str, int] = None,
                        mesh: Optional[Dict[str, int]] = None):
    """Decorator registering ``factory(device, size, shared) -> Entry``.
    ``roots`` and ``readback`` must be literals: the static analyzer reads
    them from the source. ``mesh`` (axis sizes) makes it a mesh-only entry.
    Re-registration overwrites."""

    def deco(factory):
        ENTRYPOINTS[name] = EntryPoint(name=name, factory=factory, roots=tuple(roots), readback=dict(readback or {}),
                                       mesh=dict(mesh) if mesh else None)
        return factory

    return deco


def load_all() -> Dict[str, EntryPoint]:
    """Import every module that registers hot entrypoints and return the
    registry, in census order. A new hot step means a new line here plus a
    ``@register_entrypoint`` at its definition site."""
    import trlx_tpu_torch.methods.grpo  # noqa: F401
    import trlx_tpu_torch.methods.ilql  # noqa: F401
    import trlx_tpu_torch.methods.ppo  # noqa: F401
    import trlx_tpu_torch.ops.generation  # noqa: F401
    import trlx_tpu_torch.serving.engine  # noqa: F401
    import trlx_tpu_torch.trainer.ppo_trainer  # noqa: F401

    order = ("decode_step", "paged_decode_step", "spec_verify_step", "serving_prefill", "serving_pack_step",
             "serving_chunk_step", "stream_score_bucket", "ppo_train_step", "grpo_train_step", "ilql_train_step",
             "ppo_train_step_overlap", "ppo_train_step_unsharded_opt")
    return {n: ENTRYPOINTS[n] for n in sorted(ENTRYPOINTS, key=lambda n: (order.index(n) if n in order else 99, n))}


def mesh_runs(registry: Dict[str, EntryPoint], device_type: str) -> Dict[Tuple[int, ...], list]:
    """The ``--mesh`` census: ``{(data, fsdp, pipe, model): [(name, budget
    key suffix), ...]}``, one rank group per mesh shape. The entries with
    their own mesh, keyed ``name@<device>``; on the CPU also
    :data:`ON_AUDIT_MESH` on :data:`DEFAULT_AUDIT_MESH`, keyed
    ``name@cpu:mesh``."""
    axes = ("data", "fsdp", "pipe", "model")
    runs: Dict[Tuple[int, ...], list] = {}
    for name, ep in registry.items():
        if ep.mesh is not None:
            runs.setdefault(tuple(ep.mesh[a] for a in axes), []).append((name, ""))
    if device_type == "cpu":
        shape = tuple(DEFAULT_AUDIT_MESH[a] for a in axes)
        runs.setdefault(shape, []).extend((n, ":mesh") for n in ON_AUDIT_MESH if n in registry)
    return runs
