"""Device-memory gauges (counterpart of ``trlx_tpu/obs/memory.py``).

On a CUDA device :func:`device_memory_stats` reads the caching allocator's
counters (``torch.cuda.memory_stats``) and the card's size:

- ``mem/bytes_in_use_max_gb`` — ``allocated_bytes.all.current``, the bytes
  held by live tensors;
- ``mem/peak_bytes_in_use_max_gb`` — ``allocated_bytes.all.peak``, the
  high-water mark since the process started (this module never resets it,
  as XLA's ``peak_bytes_in_use`` is never reset);
- ``mem/bytes_limit_gb`` and ``mem/utilization`` — the card's
  ``total_memory`` (device properties, which torch reads once per device)
  and current use over it.

On the CPU (as on the JAX CPU backend, whose ``memory_stats()`` is None)
the process RSS from ``/proc/self/statm`` is reported as
``mem/host_rss_gb``. A CUDA device whose allocator cannot be read raises:
the host RSS never stands in for the card. Sampling is a host-side read —
no device sync — and the trainer rate-limits it with
``observability.memory_interval``. ``_gb`` values are GiB, as in the JAX
package.
"""

import os
from typing import Dict

_GB = 1024.0 ** 3


def host_rss_bytes() -> int:
    """Resident set size of this process in bytes (0 if unreadable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def device_memory_stats(device, prefix: str = "mem/") -> Dict[str, float]:
    """Memory gauges for ``device`` (see module docstring)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        rss = host_rss_bytes()
        return {f"{prefix}host_rss_gb": rss / _GB} if rss else {}
    index = device.index if device.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(index)
    if "allocated_bytes.all.current" not in stats:
        raise RuntimeError(f"the CUDA caching allocator of {device} reported no statistics; mem/* not sampled")
    in_use = float(stats["allocated_bytes.all.current"])
    limit = float(torch.cuda.get_device_properties(index).total_memory)
    return {
        f"{prefix}bytes_in_use_max_gb": in_use / _GB,
        f"{prefix}peak_bytes_in_use_max_gb": float(stats["allocated_bytes.all.peak"]) / _GB,
        f"{prefix}bytes_limit_gb": limit / _GB,
        f"{prefix}utilization": in_use / limit,
    }
