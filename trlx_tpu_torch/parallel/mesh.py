"""Island carving over a device list (counterpart of
``trlx_tpu/parallel/mesh.py``'s ``carve_islands``; host arithmetic only).

The JAX package also builds a ``Mesh`` per island (``island_meshes``); the
port runs each island on one device and leaves meshes to the scale-out
slice. The trainer logs the placement, as the reference's does.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class IslandPlacement(NamedTuple):
    """Device carve for the Sebulba split: which devices host the generation
    island (serving engine) and which host the learner island (PPO train
    step). ``shared`` marks the single-device degenerate case where both
    islands are thread-level tenants of one device."""

    gen: Tuple
    learn: Tuple
    shared: bool


def carve_islands(gen_devices: int = 1, devices: Optional[Sequence] = None) -> IslandPlacement:
    """Carve the flat device list into disjoint generation and learner islands.

    ``devices`` defaults to every CUDA device (``cuda:0`` ..
    ``cuda:<device_count() - 1>``). The generation island takes the *last*
    ``gen_devices`` devices and the learner keeps the lowest-index prefix, so
    the learner's devices lay out as a smaller single-island run's would.
    With a single device both islands share it (thread-level islands, the
    CPU-test and single-card topology); with more, the carve is strictly
    disjoint.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    g = int(gen_devices)
    if g < 1:
        raise ValueError(f"gen_devices must be >= 1, got {g}")
    if n == 0:
        raise ValueError("carve_islands needs at least one device; pass devices=[...] without CUDA")
    if n == 1:
        return IslandPlacement((devices[0],), (devices[0],), True)
    if g >= n:
        raise ValueError(
            f"gen_devices={g} leaves no learner devices out of {n}: the carve "
            f"needs at least one device per island"
        )
    return IslandPlacement(tuple(devices[n - g:]), tuple(devices[:n - g]), False)
