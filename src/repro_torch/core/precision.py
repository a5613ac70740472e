"""bf16 multi-word splitting — the Dekker split the port's TCEC runs on.

Counterpart of ``repro.core.precision`` (bf16 parts).  An fp32 value is cut
into bf16 words ``a ≈ w0 + w1 (+ w2)``; each word is the round-to-nearest
bf16 of the running residual, so the residual ``r - f32(w)`` is exact in
fp32 and every word carries the next 8 significand bits.  Two words give
~2^-16 relative error, three ~2^-24 (full fp32).
"""
from __future__ import annotations

from typing import List

import torch

# Largest finite bf16 value.  fp32 magnitudes in (BF16_MAX, fp32 max] round
# to ±inf under a plain cast, which would make the residual
# ``a - f32(±inf) = ∓inf`` and poison every later word with NaN.
BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def bf16_word(rest: torch.Tensor) -> torch.Tensor:
    """bf16 rounding of an fp32 split residual, saturating finite overflow.

    A *finite* value above BF16_MAX saturates to ±BF16_MAX instead of
    rounding to ±inf, so the residual ``rest - f32(word)`` stays finite and
    exact.  Non-finite inputs pass through unchanged (the dot-level
    non-finite guard restores exact ±inf/NaN propagation).
    """
    w = rest.to(torch.bfloat16)
    sat = torch.isfinite(rest) & torch.isinf(w.float())
    cap = torch.where(rest > 0, BF16_MAX, -BF16_MAX).to(torch.bfloat16)
    return torch.where(sat, cap, w)


def split_words(x: torch.Tensor, n_words: int) -> List[torch.Tensor]:
    """Split an fp32 tensor into ``n_words`` bf16 words.

    The same iteration as ``repro.kernels.tcec_core.split_vregs`` (and the
    CUDA ``split_words`` of ``csrc/tcec_core.cuh``): every word but the last
    is the saturating ``bf16_word`` of the running residual; the last word
    is a plain cast.  ``n_words == 1`` is the plain bf16 cast (the
    uncorrected policy), which does not saturate.
    """
    if not 1 <= n_words <= 3:
        raise ValueError(f"n_words must be 1..3, got {n_words}")
    x = x.float()
    if n_words == 1:
        return [x.to(torch.bfloat16)]
    words = []
    rest = x
    for _ in range(n_words - 1):
        w = bf16_word(rest)
        words.append(w)
        rest = rest - w.float()
    words.append(rest.to(torch.bfloat16))
    return words

