"""Backend planning for the einsum frontend (counterpart of
``repro.tcec.planner``).

Given the equation, the resolved ``TcecPolicy`` and the epilogue, pick the
executor:

  * ``"xla"``    — the split twin (or the fp32 / native-cast contraction
                   for vpu and uncorrected policies).  Handles every
                   equation.  The name is the reference's, so plan records
                   read the same in both packages.
  * ``"pallas"`` — the hand-written CUDA TCEC matmul kernel
                   (``repro_torch.kernels.tcec_matmul``; in-register splits,
                   epilogue at the store).  Requires ``policy.kernel ==
                   "pallas"``, the tensor-core backend and a matmul-shaped
                   equation.

A ``FragmentOperand`` on either side takes the twin: the reference builds
an lhs fragment in-trace as well, and generates a data-free rhs inside its
kernel (``"pallas_fragment"``), an arm the CUDA kernel does not have yet;
here the twin splits the built rule instead.

Matmul-shaped equations:

  fold     ``L...k, kn -> L...n``   (leading dims folded into rows; this is
                                     every ``dense`` call)
  batched  ``bmk, bkn -> bmn``
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.core.policy import TcecPolicy

__all__ = ["parse_equation", "matmul_pattern", "plan_einsum", "Plan"]


@functools.lru_cache(maxsize=None)
def parse_equation(eq: str) -> Tuple[str, str, str]:
    """Split a two-operand explicit einsum equation into (ia, ib, out)."""
    eq = eq.replace(" ", "")
    if "->" not in eq:
        raise ValueError(
            f"tcec.einsum needs an explicit output ('...->...'), got {eq!r}")
    ins, out = eq.split("->")
    parts = ins.split(",")
    if len(parts) != 2:
        raise ValueError(
            f"tcec.einsum is a two-operand frontend, got {len(parts)} "
            f"operands in {eq!r}")
    ia, ib = parts
    for labels, what in ((ia, "lhs"), (ib, "rhs"), (out, "output")):
        if "." in labels:
            raise ValueError(f"ellipsis is not supported ({eq!r}); spell "
                             f"out the {what} labels")
        if len(set(labels)) != len(labels):
            raise ValueError(
                f"repeated (diagonal) labels are not supported in the "
                f"{what} of {eq!r}")
    known = set(ia) | set(ib)
    for c in out:
        if c not in known:
            raise ValueError(f"output label {c!r} of {eq!r} appears in "
                             f"neither input")
    return ia, ib, out


@functools.lru_cache(maxsize=None)
def matmul_pattern(ia: str, ib: str, out: str) -> Optional[str]:
    """Classify the equation as a kernel-expressible matmul, if it is one."""
    if len(ib) == 2 and len(ia) >= 2:
        k, n = ib
        if (ia[-1] == k and n not in ia and out == ia[:-1] + n):
            return "fold"
    if len(ia) == 3 and len(ib) == 3:
        b, m, k = ia
        if (ib[0] == b and ib[1] == k and ib[2] not in (b, m, k)
                and out == b + m + ib[2]):
            return "batched"
    return None


@dataclasses.dataclass(frozen=True)
class Plan:
    backend: str                   # "xla" | "pallas"
    pattern: Optional[str] = None  # "fold" | "batched" (kernel reshape)


def plan_einsum(ia: str, ib: str, out: str, policy: TcecPolicy,
                bias_ok: bool, a_is_frag: bool = False,
                b_is_frag: bool = False) -> Plan:
    """Pick the executor.  Anything the kernel cannot express takes the
    twin — same split arithmetic, no staged word buffers."""
    if policy.kernel != "pallas" or policy.backend != "mxu":
        return Plan("xla")
    if a_is_frag or b_is_frag:
        return Plan("xla")
    pattern = matmul_pattern(ia, ib, out)
    if pattern is None or not bias_ok:
        return Plan("xla")
    return Plan("pallas", pattern)
