"""Fragment-rule operands — the paper's ``foreach_ij`` as einsum inputs
(counterpart of ``repro.tcec.operands``).

A ``FragmentOperand`` wraps a structural rule ``rule(i, j) -> values`` plus
a logical shape, and stands in for a tensor operand of
``repro_torch.tcec.einsum``.  The frontend evaluates the rule with
``build()`` on the operand's device and hands the result to the split twin,
which splits it like any operand, except for a data-free rhs rule on the
menu below under a kernel policy: that one goes to the CUDA TCEC matmul K2
as ``frag=`` (the reference's ``"pallas_fragment"`` plan), which makes the
rule's values in its fragment registers and never builds the matrix.  The
structured kernels K7-K9 (``repro_torch.kernels.structured``) make their
fragments in registers too.

The menu.  A library built ahead of time cannot compile a Python rule, so
K2 takes a rule id and two integer arguments (``csrc/rule_menu.cuh``), the
way K8 takes (gi, gj).  ``triangular``, ``identity`` and ``banded`` make
their rule a ``MenuRule``, that spec with its plain version as its call,
so the operand's values and the kernel's come from one definition
(``FragmentOperand.menu``).  Every menu rule takes only the values 0 and
1, which are exact in one bf16 word.

Rules receive int32 index tensors (the row and column index of every
element of the trailing two dims) and may close over tensors
(Householder's ``v``, Givens' ``theta``); the value they return is
broadcast to ``shape``, so a batched fragment evaluates its index map once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FragmentOperand", "triangular", "identity", "banded",
    "householder_operand", "givens_operand", "MENU_RULES", "MenuRule",
]

Rule = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: (rule id, p0, p1): a rule of the menu and its integer arguments.
MenuSpec = Tuple[int, int, int]

#: The rule ids of ``csrc/rule_menu.cuh``: triangular (p0 upper, p1
#: strict), identity, banded (p0 k_low, p1 k_up).
MENU_RULES = {"triangular": 0, "identity": 1, "banded": 2}


@dataclasses.dataclass(frozen=True)
class MenuRule:
    """A rule of K2's menu: 1 on the band of diagonals lo <= j - i <= hi,
    0 elsewhere (``csrc/rule_menu.cuh::band``, of which the call is the
    plain version).  ``spec`` is what the kernel takes."""
    id: int
    p0: int = 0
    p1: int = 0

    def __post_init__(self):
        if self.id not in MENU_RULES.values() or any(
                abs(int(p)) >= 2 ** 31 - 1 for p in (self.p0, self.p1)):
            raise ValueError(f"menu rule {self.spec!r} is not (rule id in "
                             f"{sorted(MENU_RULES.values())}, p0, p1), each "
                             f"|p| < 2^31 - 1")

    @property
    def spec(self) -> MenuSpec:
        return (self.id, self.p0, self.p1)

    def band(self) -> Tuple[Optional[int], Optional[int]]:
        """(lo, hi) of the band, None where it is unbounded."""
        if self.id == MENU_RULES["triangular"]:
            return ((1 if self.p1 else 0), None) if self.p0 else \
                (None, (-1 if self.p1 else 0))
        if self.id == MENU_RULES["identity"]:
            return 0, 0
        return -self.p0, self.p1            # banded: p0 k_low, p1 k_up

    def __call__(self, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        d = j - i
        lo, hi = self.band()
        hold = torch.ones_like(d, dtype=torch.bool)
        if lo is not None:
            hold = hold & (d >= lo)
        if hi is not None:
            hold = hold & (d <= hi)
        return hold.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class FragmentOperand:
    """A lazy einsum operand defined by a structural rule.

    ``rule(i, j)``: i/j are int32 tensors of shape ``shape[-2:]`` on
    ``device``; the return value must broadcast to ``shape``.  ``dtype`` is
    the dtype the built operand has (splitting happens downstream per
    policy).  A ``MenuRule`` is one that K2 makes in registers.  Hashable
    (rules hash by identity, a ``MenuRule`` by its spec).
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

    @property
    def menu(self) -> Optional[MenuSpec]:
        """The menu spec (rule id, p0, p1) K2 makes this rule from, or
        ``None`` for a rule off the menu."""
        return self.rule.spec if isinstance(self.rule, MenuRule) else None

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

    def evaluate(self, device) -> torch.Tensor:
        """The rule's values on ``device`` at the index map of the trailing
        two dims, as the rule returns them (not cast, not broadcast)."""
        m, n = self.shape[-2:]
        i = torch.arange(m, dtype=torch.int32,
                         device=device)[:, None].expand(m, n)
        j = torch.arange(n, dtype=torch.int32,
                         device=device)[None, :].expand(m, n)
        return torch.as_tensor(self.rule(i, j), device=device)

    def build(self) -> torch.Tensor:
        """Evaluate the rule on ``device``: (shape) at ``dtype``."""
        return self.evaluate(self.device).to(self.dtype).broadcast_to(
            self.shape)


# ---------------------------------------------------------------------------
# Prebuilt structural rules (paper §4.1–4.3) as operands.
# ---------------------------------------------------------------------------

# The data-free constructors are cached, as in the reference: the same
# static inputs give the same operand (and the same rule object).

@functools.lru_cache(maxsize=None)
def triangular(n: int, upper: bool = True, strict: bool = False,
               dtype=torch.float32, device="cuda") -> FragmentOperand:
    """U with u_ij = 1 iff i<=j (paper Eq. 3) — the scan/cumsum operand."""
    return FragmentOperand(
        MenuRule(MENU_RULES["triangular"], int(upper), int(strict)),
        (n, n), dtype, "triangular", device)


@functools.lru_cache(maxsize=None)
def identity(n: int, dtype=torch.float32, device="cuda") -> FragmentOperand:
    return FragmentOperand(MenuRule(MENU_RULES["identity"]), (n, n), dtype,
                           "identity", device)


@functools.lru_cache(maxsize=None)
def banded(n: int, k_low: int, k_up: int, dtype=torch.float32,
           device="cuda") -> FragmentOperand:
    """Band of ones: nonzero where -k_low <= j - i <= k_up."""
    return FragmentOperand(
        MenuRule(MENU_RULES["banded"], int(k_low), int(k_up)),
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
