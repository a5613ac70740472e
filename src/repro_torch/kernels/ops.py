"""Public wrappers of the structured ops (counterpart of
``repro.kernels.ops``: ``householder``, ``givens``, ``cumsum``).

On CUDA tensors each op launches its kernel (K7, K8, K9 of
``repro_torch.kernels.structured``); on CPU tensors it runs the kernel's
plain version.  The reference's TPU-only switches (``force_pallas``,
``interpret``) have no counterpart: the tensor's device decides.  The
deprecated shims ``tcec_matmul`` and ``dense``, and ``attention``, are not
ported yet.
"""
from __future__ import annotations

import torch

from .structured import givens_apply, householder_apply, scan_cumsum

__all__ = ["householder", "givens", "cumsum"]


def householder(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(I - 2vv^T) A per batch, with H made from its rule, never stored."""
    return householder_apply(v, a)


def givens(theta: torch.Tensor, a: torch.Tensor, gi: int, gj: int
           ) -> torch.Tensor:
    """G(gi, gj, theta_b) A_b — the identity plus four map-set entries."""
    return givens_apply(theta, a, gi, gj)


def cumsum(x: torch.Tensor, block_n: int = 256) -> torch.Tensor:
    """Row-wise cumsum as blockwise x·U on the tensor cores (paper Eq. 3),
    with a carried block offset.  ``block_n`` is cut to n and must divide
    it (``ValueError`` otherwise)."""
    return scan_cumsum(x, block_n)
