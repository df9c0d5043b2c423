"""Auto-resume: find the newest *committed* checkpoint, restore full state
(counterpart of ``trlx_tpu/resilience/resume.py``).

1. **Selection** (:func:`find_latest_committed`): scan ``checkpoint_dir`` for
   ``checkpoint_<step>`` directories, order by **numeric** step (robust to
   legacy unpadded names, where lexicographic order put ``checkpoint_9``
   after ``checkpoint_10``), and return the newest one carrying the
   ``_COMMITTED`` sentinel. Torn directories are skipped with a warning,
   falling back to the next-newest committed one. ``best_checkpoint`` is
   deliberately *not* a resume candidate: it is reward-ordered, not
   time-ordered.

2. **State** (the trainer's ``_state_dict``/``load``): beyond params and
   optimizer, a faithful resume restores ``iter_count``, ``best_reward``,
   the eval counter, every RNG stream and the dataloader position.

RNG packing: the reference packs a jax PRNG key into uint32 words; the
port's sampling stream is a ``torch.Generator``, whose ``get_state()`` is a
CPU ``uint8`` tensor (for a CUDA generator too), packed as a JSON list of
its bytes. Numpy state is the ``bit_generator.state`` dict, which is
JSON-clean for PCG64.
"""

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.resilience.checkpoint import COMMITTED_SENTINEL, TMP_SUFFIX, is_committed
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

CHECKPOINT_PREFIX = "checkpoint_"


def checkpoint_step(name: str, prefix: str = CHECKPOINT_PREFIX) -> Optional[int]:
    """Numeric step from a ``checkpoint_<step>`` dir name; None if not one."""
    if not name.startswith(prefix) or name.endswith(TMP_SUFFIX):
        return None
    suffix = name[len(prefix):]
    if not suffix.isdigit():
        return None
    return int(suffix)


def list_checkpoints(checkpoint_dir: str) -> List[Tuple[int, str]]:
    """All step-checkpoint dirs under ``checkpoint_dir`` as (step, path),
    sorted by step ascending — committed or not."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in sorted(os.listdir(checkpoint_dir)):
        step = checkpoint_step(name)
        path = os.path.join(checkpoint_dir, name)
        if step is not None and os.path.isdir(path):
            out.append((step, path))
    out.sort(key=lambda sp: sp[0])
    return out


def find_latest_committed(checkpoint_dir: str) -> Optional[str]:
    """Newest committed step checkpoint, skipping torn dirs (see module doc)."""
    for step, path in reversed(list_checkpoints(checkpoint_dir)):
        if is_committed(path):
            return path
        logger.warning(
            f"Auto-resume: skipping {path} — no {COMMITTED_SENTINEL} sentinel "
            "(torn or in-flight write)"
        )
    return None


# ------------------------------------------------------------------ RNG state


def pack_rng_key(generator: torch.Generator) -> List[int]:
    """``torch.Generator`` (the port's sampling key) -> JSON-clean list of
    its state bytes."""
    return generator.get_state().tolist()


def unpack_rng_key(words: List[int], like: torch.Generator) -> torch.Generator:
    """Inverse of :func:`pack_rng_key`: ``like`` takes the packed state and
    is returned (the state is a CPU ``uint8`` tensor whatever the
    generator's device)."""
    like.set_state(torch.tensor(words, dtype=torch.uint8))
    return like


def pack_np_rng(np_rng: np.random.Generator) -> Dict[str, Any]:
    """numpy Generator -> its JSON-serializable bit_generator state dict."""
    return np_rng.bit_generator.state


def restore_np_rng(np_rng: np.random.Generator, state: Dict[str, Any]) -> None:
    np_rng.bit_generator.state = state
