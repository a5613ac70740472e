"""Fragment generation from structural rules — the ``foreach_ij``/``map``
analogue (counterpart of ``repro.core.fragment``).

WMMAe's ``foreach_ij`` hands a lambda the (i, j) matrix position, so a
structured matrix (triangular, Householder, Givens, ...) is built element by
element from a rule instead of being loaded.  These are the plain PyTorch
versions: ``rule(i, j)`` gets int32 index tensors of shape (m, n) and
returns the elements.  The CUDA kernels of ``repro_torch.kernels.structured``
evaluate the same rules per thread, at the (row, col) positions of its
``mma.sync`` fragment registers, and never store the matrix.

The arithmetic follows the reference op for op (e.g. Householder's
``eye - 2.0 * v_i * v_j``), so every matrix here is bitwise the
reference's.  Functions that make a matrix from nothing take an explicit
``device`` (``"cuda"`` by default, like the port's other entry points).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = [
    "foreach_ij", "map_set", "map_get",
    "triangular_ones", "identity", "householder", "givens", "banded",
]

Rule = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def foreach_ij(rule: Rule, m: int, n: int, dtype=torch.float32, *,
               device="cuda") -> torch.Tensor:
    """Build an (m, n) matrix from ``rule(i, j)``; ``i`` and ``j`` are int32
    index tensors of shape (m, n) on ``device``."""
    i = torch.arange(m, dtype=torch.int32, device=device)[:, None].expand(m, n)
    j = torch.arange(n, dtype=torch.int32, device=device)[None, :].expand(m, n)
    return rule(i, j).to(dtype)


def map_set(frag: torch.Tensor, i, j, value) -> torch.Tensor:
    """WMMAe ``map``: a copy of ``frag`` with element (i, j) set."""
    out = frag.clone()
    out[..., i, j] = value
    return out


def map_get(frag: torch.Tensor, i, j) -> torch.Tensor:
    """WMMAe ``map``: element (i, j) of a matrix held as a fragment."""
    return frag[..., i, j]


# ---------------------------------------------------------------------------
# Prebuilt structural rules (the paper's §4 examples).
# ---------------------------------------------------------------------------

def _f32(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.float32)


def triangular_ones(n: int, upper: bool = True, strict: bool = False,
                    dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """U with u_ij = 1 iff i <= j (paper Eq. 3) — the scan/cumsum operand."""
    if upper:
        rule = (lambda i, j: i < j) if strict else (lambda i, j: i <= j)
    else:
        rule = (lambda i, j: i > j) if strict else (lambda i, j: i >= j)
    return foreach_ij(lambda i, j: _f32(rule(i, j)), n, n, dtype,
                      device=device)


def identity(n: int, dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    return foreach_ij(lambda i, j: _f32(i == j), n, n, dtype, device=device)


def householder(v: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """H = I - 2 v v^T from v, element by element, on v's device.

    v: (..., m) -> (..., m, m).  The rule is WMMAe's lambda
    ``elm = -2 v[i] v[j]; if (i==j) elm += 1``, evaluated as the reference
    does: ``(i == j) - (2 v_i) v_j`` in fp32.
    """
    m = v.shape[-1]
    v32 = v.to(torch.float32)
    eye = identity(m, device=v.device)
    h = eye - 2.0 * v32[..., :, None] * v32[..., None, :]
    return h.to(dtype)


def givens(n: int, i: int, j: int, theta, dtype=torch.float32, *,
           device=None) -> torch.Tensor:
    """Givens rotation G(i, j, theta) (paper §4.3): the identity, then the
    four rotation entries set in the reference's order (c, c, s, -s).
    ``device`` defaults to ``theta``'s when it is a tensor."""
    if device is None:
        device = theta.device if isinstance(theta, torch.Tensor) else "cuda"
    theta = torch.as_tensor(theta, device=device)
    c = torch.cos(theta).to(dtype)
    s = torch.sin(theta).to(dtype)
    g = identity(n, dtype, device=device)
    g = map_set(g, i, i, c)
    g = map_set(g, j, j, c)
    g = map_set(g, i, j, s)
    g = map_set(g, j, i, -s)
    return g


def banded(n: int, k_low: int, k_up: int, dtype=torch.float32, *,
           device="cuda") -> torch.Tensor:
    """Band matrix of ones: nonzero where -k_low <= j - i <= k_up."""
    return foreach_ij(lambda i, j: _f32((j - i <= k_up) & (i - j <= k_low)),
                      n, n, dtype, device=device)
