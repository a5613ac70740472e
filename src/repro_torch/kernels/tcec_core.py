"""Shared TCEC split/accumulate core — plain PyTorch versions.

Counterpart of ``repro.kernels.tcec_core`` (bf16 arms).  The CUDA device
functions every kernel of the port inlines live in ``csrc/tcec_core.cuh``
(K1); these are their plain versions, used by the kernels' plain versions
and by the CPU tests:

  * ``split_vregs(x, n_words)``  — fp32 -> n bf16 Dekker words, saturating;
  * ``mma_passes(aw, bw, schedule, eq)`` — the scheduled passes, each an
    fp32 einsum of bf16-valued tensors (exact products, fp32 sums); the
    one pass loop, shared with the twin (``repro_torch.core.tcec``);
  * ``policy_dot(a, b, eq, n_words=, schedule=, vpu=)`` — both together.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.policy import SCHEDULES, TcecPolicy
from repro_torch.core.precision import split_words
from repro_torch.core.tcec import mma_passes

__all__ = ["SCHEDULES", "split_vregs", "mma_passes", "policy_dot",
           "dot_params", "kernel_passes"]

# (m, k) @ (k, n) — the default contraction.
MATMUL_EQ = "mk,kn->mn"


def split_vregs(x: torch.Tensor, n_words: int) -> List[torch.Tensor]:
    """Split an fp32 tensor into bf16 words (bitwise the reference's words:
    ``n_words == 1`` is the plain cast; otherwise each word but the last
    saturates finite overflow to ±BF16_MAX)."""
    return split_words(x, n_words)


def policy_dot(a: torch.Tensor, b: torch.Tensor, eq: str = MATMUL_EQ, *,
               n_words: int, schedule, vpu: bool) -> torch.Tensor:
    """Policy-selected-precision contraction (no non-finite guard, as in
    the reference's kernel bodies): vpu = plain fp32; otherwise split both
    operands into bf16 words and accumulate the scheduled passes."""
    if vpu:
        return torch.einsum(eq, a.float(), b.float())
    aw = split_vregs(a.float(), n_words)
    bw = split_vregs(b.float(), n_words)
    return mma_passes(aw, bw, schedule, eq)


def dot_params(policy: TcecPolicy) -> Dict:
    """``policy_dot`` keyword arguments for a policy (bf16 words only)."""
    if policy.word_dtype != "bf16":
        raise NotImplementedError(
            f"word_dtype={policy.word_dtype!r} is not ported yet")
    return dict(n_words=policy.n_words, schedule=policy.schedule,
                vpu=policy.backend == "vpu")


def kernel_passes(policy: TcecPolicy, what: str) -> int:
    """The pass count a CUDA kernel is built for; raises on the policy arms
    the kernels do not take yet (vpu, int8 words, bf16x9)."""
    from ._build import PASSES
    if policy.backend != "mxu":
        raise NotImplementedError(
            f"{what}: the vpu (plain fp32) arm has no CUDA kernel yet")
    if policy.word_dtype != "bf16":
        raise NotImplementedError(
            f"{what}: word_dtype={policy.word_dtype!r} has no CUDA kernel "
            f"yet")
    if policy.passes not in PASSES:
        raise NotImplementedError(
            f"{what}: {policy.passes} passes — the kernels are built for "
            f"{PASSES}")
    return policy.passes
