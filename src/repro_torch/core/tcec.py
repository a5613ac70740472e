"""TCEC — fp32-accurate contraction emulated with bf16 tensor-core passes.

Counterpart of ``repro.core.tcec`` (bf16 parts).  The arithmetic of
Ootomo & Yokota's error correction:

    A = A_0 + A_1 (+ A_2)      (bf16 words, Dekker-exact split)
    C = sum of scheduled cross-term products, smallest magnitude first.

``split_contract`` is the *twin*: the same schedule written as torch ops.
Each pass (``mma_passes``, the one pass loop of the port's plain code) is an
fp32 ``einsum`` of tensors that hold bf16 values, so every product is exact
(8 x 8 significand bits fit in fp32's 24) and only the fp32 summation order
differs from a tensor-core pass.  The CUDA kernels of ``repro_torch.kernels``
run the same schedule on ``mma.sync``.

The non-finite guard keeps a split schedule's ±inf/NaN behaviour identical
to an fp32 dot: operands are sanitized before splitting (a split word of a
non-finite value poisons every later word), and where the fp32 reference
contraction is non-finite its value replaces the schedule's.
``nonfinite_guard`` checks the inputs on the host, which is free on CPU
tensors.  ``split_contract`` takes the guard as a callable, so its caller
(the frontend, ``repro_torch.tcec.frontend``) can keep the check on the
card for CUDA tensors — a device flag and the fix-up kernel, the
reference's ``lax.cond``.  ``GUARD_SYNCS`` counts the host syncs a guard
still makes on a CUDA tensor.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .counters import counter
from .policy import TcecPolicy
from .precision import split_words

__all__ = ["split_words", "sanitize_nonfinite", "nonfinite_guard",
           "mma_passes", "split_contract", "Guard", "GUARD_SYNCS"]

#: Host syncs made by a non-finite guard on a CUDA tensor (``all_finite``):
#: every wired path keeps its guard on the card, so this stays 0 there.
GUARD_SYNCS = counter("guard_host_sync")


def sanitize_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Zero out ±inf/NaN so split schedules never see them (fp32 out).
    The identity, bitwise, on all-finite inputs."""
    x = x.float()
    return torch.where(torch.isfinite(x), x, torch.zeros((), device=x.device))


def all_finite(*xs: torch.Tensor) -> bool:
    """True when every element of every tensor is finite (a host read;
    counted in ``GUARD_SYNCS`` when it syncs a CUDA device)."""
    ok = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        ok = ok & torch.isfinite(x).all()
    if ok.is_cuda:
        GUARD_SYNCS.hit()
    return bool(ok)


def nonfinite_guard(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    ref_fn: Callable, post: Optional[Callable] = None
                    ) -> torch.Tensor:
    """Make a split-schedule result propagate ±inf/NaN like the fp32 dot.

    ``out`` was computed from sanitized operands.  When any input element
    is non-finite, ``ref_fn(a, b)`` — the fp32 reference contraction on the
    original operands — supplies the ±inf/NaN entries, mapped through
    ``post`` (what followed the contraction: the matmul kernel's epilogue)
    before they replace ``out``'s.  The reference runs only then.  The
    inputs are checked here on the host (``all_finite``), which is free on
    CPU tensors; the port's CUDA paths do not come here but run the fix-up
    kernel on a device flag instead (``repro_torch.kernels.nonfinite``), as
    the reference's ``lax.cond`` keeps its check on the device.
    """
    if all_finite(a, b):
        return out
    ref = ref_fn(a, b)
    mask = torch.isfinite(ref)
    if post is not None:
        ref = post(ref)
    return torch.where(mask, out, ref.to(out.dtype))


def _einsum32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.float(), b.float())


def mma_passes(aw: Sequence[torch.Tensor], bw: Sequence[torch.Tensor],
               schedule, eq: str) -> torch.Tensor:
    """Run the pass schedule over split words; fp32 sum in schedule order."""
    acc = None
    for (i, j) in schedule:
        term = _einsum32(eq, aw[i], bw[j])
        acc = term if acc is None else acc + term
    return acc


#: A guard ``split_contract`` may be given: ``guard(eq, out, a32, b32)``
#: returns the guarded product, or None to leave it to ``nonfinite_guard``.
Guard = Callable[[str, torch.Tensor, torch.Tensor, torch.Tensor],
                 Optional[torch.Tensor]]


def split_contract(eq: str, a: torch.Tensor, b: torch.Tensor,
                   policy: TcecPolicy, guard: Optional[Guard] = None
                   ) -> torch.Tensor:
    """The bf16 split schedule of ``policy`` as torch ops; fp32 result.

    ``passes == 1`` is the plain single-word cast (±inf/NaN propagate
    through the products naturally, no guard); corrected policies split the
    sanitized operands, sum the scheduled passes in order and run the
    non-finite guard: ``guard`` when it is given and returns a result, else
    the host check ``nonfinite_guard`` (counted in ``GUARD_SYNCS`` on a
    CUDA tensor).  Both operands may be any float dtype.
    """
    if policy.word_dtype != "bf16":
        raise NotImplementedError(
            f"word_dtype={policy.word_dtype!r} is not ported yet")
    if not policy.error_correction:
        return mma_passes(split_words(a, 1), split_words(b, 1),
                          policy.schedule, eq)
    a32, b32 = a.float(), b.float()
    aw = split_words(sanitize_nonfinite(a32), policy.n_words)
    bw = split_words(sanitize_nonfinite(b32), policy.n_words)
    out = mma_passes(aw, bw, policy.schedule, eq)
    if guard is not None:
        fixed = guard(eq, out, a32, b32)
        if fixed is not None:
            return fixed
    return nonfinite_guard(out, a32, b32,
                           lambda a_, b_: _einsum32(eq, a_, b_))
