"""The port's hand-written CUDA kernels (sources in ``repro_torch/csrc``),
each with its plain PyTorch version and a launch counter.

  * K1 ``csrc/tcec_core.cuh`` — the shared split/accumulate core
    (plain versions in ``tcec_core``);
  * K2 ``tcec_matmul.tcec_matmul_fused`` — TCEC matmul + fused epilogue;
  * K2b ``tcec_matmul.tcec_matmul_pallas`` — the same body, fp32 in and
    out, over a tile menu, with its vpu (plain fp32) arm;
  * K5 ``tcec_matmul.tcec_matmul_staged`` and K6
    ``tcec_matmul.tcec_matmul_staged_db`` — the staged-word baseline,
    single- and double-buffered; ``tcec_matmul.tcec_matmul_auto``
    dispatches to K2b, K5 or K6 through ``repro_torch.tune``;
  * K3 ``flash_attention.flash_attention`` — prefill attention (on
    ``flash_attention.k3_plan``: where the grid is short of the card, kv
    splits, their max pass and merge from one host call);
  * K4 ``repro_torch.serving.paged_attention.paged_decode_attention_kernel``
    — paged decode attention (scores, split softmax·V and merge kernels
    from one host call, on ``k4_plan``);
  * the non-finite fix-up ``nonfinite.nonfinite_fixup`` — a corrected
    policy's guard on the card (K2 folds it into its reduce kernel);
  * K7 ``structured.householder_apply``, K8 ``structured.givens_apply`` and
    K9 ``structured.scan_cumsum`` — the structured-fragment ops (H, G and
    the triangular ones made in registers, never stored), reached through
    ``ops.householder``, ``ops.givens`` and ``ops.cumsum``.

``launch_counts()`` / ``reset_launch_counts()`` read and zero every
kernel's counter (a wrapper counts only its own kernel launches), and
``guard_host_sync``, the host syncs a non-finite guard made on a CUDA
tensor (``repro_torch.core.tcec.GUARD_SYNCS``).
"""
from typing import Dict

from ._build import COUNTERS


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset."""
    # Importing the wrappers registers every counter.
    from . import flash_attention, nonfinite  # noqa: F401
    from . import structured, tcec_matmul  # noqa: F401
    from repro_torch.serving import paged_attention  # noqa: F401
    return {name: c.n for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    launch_counts()
    for c in COUNTERS.values():
        c.reset()
