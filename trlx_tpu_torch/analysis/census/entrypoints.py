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

Import-light on purpose: registering modules import it at module scope.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple


@dataclass
class Entry:
    """What a factory returns."""

    step: Callable[[int], Any]  #: one step on content variant k
    warmup: Sequence[int] = (0,)
    steady: Sequence[int] = (1, 2)


@dataclass
class EntryPoint:
    name: str
    factory: Callable[..., Entry]
    roots: Tuple[str, ...]
    readback: Dict[str, int]


#: name -> EntryPoint; populated by :func:`register_entrypoint` at import time
ENTRYPOINTS: Dict[str, EntryPoint] = {}


def register_entrypoint(name: str, *, roots: Sequence[str] = (), readback: Dict[str, int] = None):
    """Decorator registering ``factory(device, size, shared) -> Entry``.
    ``roots`` and ``readback`` must be literals: the static analyzer reads
    them from the source. Re-registration overwrites."""

    def deco(factory):
        ENTRYPOINTS[name] = EntryPoint(name=name, factory=factory, roots=tuple(roots), readback=dict(readback or {}))
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
             "serving_chunk_step", "stream_score_bucket", "ppo_train_step", "grpo_train_step", "ilql_train_step")
    return {n: ENTRYPOINTS[n] for n in sorted(ENTRYPOINTS, key=lambda n: (order.index(n) if n in order else 99, n))}
