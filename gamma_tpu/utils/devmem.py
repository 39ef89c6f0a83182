"""Device-memory byte budgets.

Every byte budget in the package (dense-mirror and SQ8-sidecar
admission, the exact-scan gather chunking, the flat k-means distance
matrix) is written as its value for a 16 GiB device.  On an accelerator
the budget is the same fraction of what XLA may allocate on the device
that holds the data (`memory_stats()["bytes_limit"]`, which already
reflects XLA_PYTHON_CLIENT_MEM_FRACTION).  On the CPU backend the
written constants apply unchanged.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax

BUDGET_BASE_BYTES = 16 << 30


@functools.lru_cache(maxsize=None)
def _bytes_limit(device) -> int:
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device} reports no memory_stats()['bytes_limit']; device "
            "memory budgets cannot be sized")
    return int(stats["bytes_limit"])


def device_of(x) -> Optional[jax.Device]:
    """The (first) device holding array `x`, or None for host data."""
    devs = getattr(x, "devices", None)
    if devs is None:
        return None
    return next(iter(devs()))


def scaled_budget(nbytes: int, device: Optional[jax.Device] = None) -> int:
    """`nbytes` (a budget written for a 16 GiB device) scaled to
    `device` (default: the default device)."""
    dev = device if device is not None else jax.devices()[0]
    if dev.platform == "cpu":
        return int(nbytes)
    return int(nbytes * _bytes_limit(dev) // BUDGET_BASE_BYTES)
