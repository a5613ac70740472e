"""Analytic scoring — the predict tier (counterpart of ``repro.tune.model``,
matmul half).  A pure-Python float from a ``ChipSpec`` and the candidate's
static shape: no torch, no clocks, no randomness."""
from __future__ import annotations

from typing import Optional

from repro_torch.core.policy import TcecPolicy
from repro_torch.core.roofline import (ChipSpec, active_chip,
                                       predict_matmul_time)
from .space import MatmulCandidate


def score_matmul(m: int, n: int, k: int, batch: int, cand: MatmulCandidate,
                 policy: TcecPolicy, rhs_batched: bool = True,
                 chip: Optional[ChipSpec] = None) -> float:
    """Predicted seconds for one matmul candidate (see
    ``core.roofline.predict_matmul_time`` for the model)."""
    return predict_matmul_time(
        m, n, k, batch=batch, block=cand.block, variant=cand.variant,
        passes=policy.passes, n_words=policy.n_words,
        rhs_batched=rhs_batched, chip=chip or active_chip())
