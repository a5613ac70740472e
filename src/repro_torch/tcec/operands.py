"""Fragment-rule operands — the paper's ``foreach_ij`` as einsum inputs
(counterpart of ``repro.tcec.operands``).

A ``FragmentOperand`` wraps a structural rule ``rule(i, j) -> values`` plus
a logical shape, and stands in for a tensor operand of
``repro_torch.tcec.einsum``.  The frontend evaluates the rule with
``build()`` on the operand's device and hands the result to the split twin,
which splits it like any operand: the CUDA TCEC matmul's in-kernel rule
arm (the reference's ``frag=``) is not ported, so no fragment reaches a
kernel through the frontend.  The structured kernels K7-K9
(``repro_torch.kernels.structured``) make their fragments in registers.

Rules receive int32 index tensors (the row and column index of every
element of the trailing two dims) and may close over tensors
(Householder's ``v``, Givens' ``theta``); the value they return is
broadcast to ``shape``, so a batched fragment evaluates its index map once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = [
    "FragmentOperand", "triangular", "identity", "banded",
    "householder_operand", "givens_operand",
]

Rule = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FragmentOperand:
    """A lazy einsum operand defined by a structural rule.

    ``rule(i, j)``: i/j are int32 tensors of shape ``shape[-2:]`` on
    ``device``; the return value must broadcast to ``shape``.  ``dtype`` is
    the dtype the built operand has (splitting happens downstream per
    policy).  Hashable (rules hash by identity).
    """
    rule: Rule
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    name: str = "fragment"
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        if len(self.shape) < 2:
            raise ValueError(
                f"FragmentOperand needs a >=2-D shape, got {self.shape}")
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def closes_over_arrays(self) -> bool:
        """True if the rule captures tensor data (Householder's v, Givens'
        theta): the reference's planner keeps such rules out of its kernel
        body, whose arguments are static."""
        for cell in getattr(self.rule, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:          # empty cell
                continue
            if isinstance(v, (torch.Tensor, np.ndarray)):
                return True
        return False

    def build(self) -> torch.Tensor:
        """Evaluate the rule on ``device``: (shape) at ``dtype``."""
        m, n = self.shape[-2:]
        i = torch.arange(m, dtype=torch.int32,
                         device=self.device)[:, None].expand(m, n)
        j = torch.arange(n, dtype=torch.int32,
                         device=self.device)[None, :].expand(m, n)
        val = torch.as_tensor(self.rule(i, j), device=self.device)
        return val.to(self.dtype).broadcast_to(self.shape)


# ---------------------------------------------------------------------------
# Prebuilt structural rules (paper §4.1–4.3) as operands.
# ---------------------------------------------------------------------------

# The data-free constructors are cached, as in the reference: the same
# static inputs give the same operand (and the same rule object).

@functools.lru_cache(maxsize=None)
def triangular(n: int, upper: bool = True, strict: bool = False,
               dtype=torch.float32, device="cuda") -> FragmentOperand:
    """U with u_ij = 1 iff i<=j (paper Eq. 3) — the scan/cumsum operand."""
    if upper:
        cmp = (lambda i, j: i < j) if strict else (lambda i, j: i <= j)
    else:
        cmp = (lambda i, j: i > j) if strict else (lambda i, j: i >= j)
    return FragmentOperand(lambda i, j: cmp(i, j).to(torch.float32),
                           (n, n), dtype, "triangular", device)


@functools.lru_cache(maxsize=None)
def identity(n: int, dtype=torch.float32, device="cuda") -> FragmentOperand:
    return FragmentOperand(lambda i, j: (i == j).to(torch.float32),
                           (n, n), dtype, "identity", device)


@functools.lru_cache(maxsize=None)
def banded(n: int, k_low: int, k_up: int, dtype=torch.float32,
           device="cuda") -> FragmentOperand:
    """Band of ones: nonzero where -k_low <= j - i <= k_up."""
    return FragmentOperand(
        lambda i, j: ((j - i <= k_up) & (i - j <= k_low)).to(torch.float32),
        (n, n), dtype, "banded", device)


def householder_operand(v: torch.Tensor, dtype=torch.float32
                        ) -> FragmentOperand:
    """H = I - 2 v v^T from ``v`` (..., m) — the paper's Code 4/5 lambda,
    on v's device.  The rule closes over ``v``; (..., m, m)."""
    m = v.shape[-1]

    def rule(i, j):
        eye = (i == j).to(torch.float32)
        vf = v.to(torch.float32)
        if v.dim() == 1:
            return eye - 2.0 * vf[i.long()] * vf[j.long()]
        return eye - 2.0 * vf[..., :, None] * vf[..., None, :]

    return FragmentOperand(rule, (*v.shape[:-1], m, m), dtype,
                           "householder", v.device)


def givens_operand(n: int, gi: int, gj: int, theta, dtype=torch.float32,
                   device=None) -> FragmentOperand:
    """G(gi, gj, theta) built by fill + map-style element sets (paper §4.3).
    ``theta`` scalar or (b,); ``device`` defaults to theta's when it is a
    tensor, else the card."""
    if device is None:
        device = theta.device if isinstance(theta, torch.Tensor) else "cuda"
    theta = torch.as_tensor(theta, device=device)
    batch = tuple(theta.shape)

    def rule(i, j):
        c = torch.cos(theta.to(torch.float32))
        s = torch.sin(theta.to(torch.float32))
        if batch:
            c, s = c[..., None, None], s[..., None, None]
        g = (i == j).to(torch.float32)
        g = torch.where((i == gi) & (j == gi), c, g)
        g = torch.where((i == gj) & (j == gj), c, g)
        g = torch.where((i == gi) & (j == gj), s, g)
        g = torch.where((i == gj) & (j == gi), -s, g)
        return g

    return FragmentOperand(rule, (*batch, n, n), dtype, "givens", device)
