"""The port's hand-written CUDA kernels (sources in ``repro_torch/csrc``),
each with its plain PyTorch version and a launch counter.

  * K1 ``csrc/tcec_core.cuh`` — the shared split/accumulate core
    (plain versions in ``tcec_core``);
  * K2 ``tcec_matmul.tcec_matmul_fused`` — TCEC matmul + fused epilogue;
  * K3 ``flash_attention.flash_attention`` — prefill attention;
  * K4 ``repro_torch.serving.paged_attention.paged_decode_attention_kernel``
    — paged decode attention.

``launch_counts()`` / ``reset_launch_counts()`` read and zero every
kernel's counter (a wrapper counts only its own kernel launches).
"""
from typing import Dict

from ._build import COUNTERS


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset."""
    # Importing the wrappers registers every counter.
    from . import flash_attention, tcec_matmul  # noqa: F401
    from repro_torch.serving import paged_attention  # noqa: F401
    return {name: c.n for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    launch_counts()
    for c in COUNTERS.values():
        c.reset()
