"""Named event counters: each kernel wrapper's launch counter, and the host
syncs a non-finite guard makes on a CUDA tensor.  ``repro_torch.kernels.
launch_counts()`` reads them all, ``reset_launch_counts()`` zeroes them."""
from __future__ import annotations

from typing import Dict


class LaunchCounter:
    """Counts a kernel's launches: its wrapper adds one where it launches
    the kernel, and nowhere else (plain-version calls do not count)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def hit(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


#: counter name -> its counter (one per wrapper module).
COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    c = LaunchCounter(name)
    COUNTERS[name] = c
    return c
