"""Public wrappers of the structured ops (counterpart of
``repro.kernels.ops``: ``householder``, ``givens``, ``cumsum``).

On CUDA tensors each op launches its kernel (K7, K8, K9 of
``repro_torch.kernels.structured``), as the reference runs its Pallas
kernel on its own chip whatever the policy.  On CPU tensors each op runs
the reference's fallback: the same rule as a ``FragmentOperand`` through
the einsum frontend at the ``"structured"`` site with
``precision="strict"``, under whatever policy is active there (the
default, ``bf16x1`` strict, is the kernel's one bf16 pass).  The
reference's TPU-only switches (``force_pallas``, ``interpret``) have no
counterpart: the tensor's device decides.  The deprecated shims
``tcec_matmul`` and ``dense``, and ``attention``, are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch import tcec
from .structured import (_batched, _device, _scan_block, givens_apply,
                         householder_apply, scan_cumsum)

__all__ = ["householder", "givens", "cumsum"]

SITE = "structured"


def _strict(eq: str, a, b) -> torch.Tensor:
    return tcec.einsum(eq, a, b, site=SITE, precision="strict")


def householder(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(I - 2vv^T) A per batch, with H made from its rule: in registers,
    never stored (K7), on the card; a ``FragmentOperand`` through the
    frontend on the CPU."""
    if _device("householder_apply", v, a).type == "cuda":
        return householder_apply(v, a)
    _batched("householder_apply", v, "b, m", a)
    return _strict("bij,bjk->bik", tcec.householder_operand(v), a)


def givens(theta: torch.Tensor, a: torch.Tensor, gi: int, gj: int
           ) -> torch.Tensor:
    """G(gi, gj, theta_b) A_b — the identity plus four map-set entries."""
    if _device("givens_apply", theta, a).type == "cuda":
        return givens_apply(theta, a, gi, gj)
    _batched("givens_apply", theta, "b", a)
    frag = tcec.givens_operand(a.shape[-2], gi, gj, theta)
    return _strict("bij,bjk->bik", frag, a)


def cumsum(x: torch.Tensor, block_n: int = 256) -> torch.Tensor:
    """Row-wise cumsum as blockwise x·U on the tensor cores (paper Eq. 3),
    with a carried block offset.  ``block_n`` is cut to n and must divide
    it (``ValueError`` otherwise).  On the CPU: the triangular-ones
    ``FragmentOperand`` per block with the carry, through the frontend."""
    if _device("scan_cumsum", x).type == "cuda":
        return scan_cumsum(x, block_n)
    block_n = _scan_block(x, block_n)
    rows, n = x.shape
    x = x.float()
    tri = tcec.triangular(block_n, device=x.device)
    outs = []
    carry = torch.zeros(rows, 1, dtype=torch.float32, device=x.device)
    for j0 in range(0, n, block_n):
        ob = _strict("rn,nm->rm", x[:, j0:j0 + block_n], tri) + carry
        carry = ob[:, -1:]
        outs.append(ob)
    return torch.cat(outs, dim=1)
