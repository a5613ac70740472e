"""Candidate enumeration for the matmul site (counterpart of
``repro.tune.space``, matmul half).

On a TPU spec the space is the reference's: MXU-aligned (bm, bn, bk) tiles
up to the chip-derived caps, filtered by the staging budget.  On a ``cuda``
spec (the H100) it is the compiled tile menu of each variant
(``repro_torch.kernels._build.TILES``) whose shared memory fits the
per-block limit.  Ordering is fixed, so the analytic tier is reproducible
across processes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.policy import TcecPolicy
from repro_torch.core.roofline import (ChipSpec, LANE, SUBLANE, active_chip,
                                       derive_block_caps,
                                       matmul_tile_footprint,
                                       staging_budget_bytes)
from repro_torch.kernels._build import TILES


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class MatmulCandidate:
    block: Tuple[int, int, int]
    variant: str                  # "fused" | "staged" | "staged_db" | "vpu"


def _axis_options(dim: int, align: int, cap: int) -> List[int]:
    """Aligned tile sizes for one axis: powers of two of the alignment up to
    the cap, plus the exact padded dim when it is smaller than the cap."""
    opts = set()
    t = align
    while t <= cap:
        opts.add(t)
        t *= 2
    padded = _round_up(dim, align)
    if padded <= cap:
        opts.add(padded)
    opts = {min(o, cap) for o in opts}
    # Tiles beyond one padded dim only waste flops — drop them.
    opts = {o for o in opts if o <= max(_round_up(dim, align), align)}
    return sorted(opts)


def matmul_variants(policy: TcecPolicy) -> Tuple[str, ...]:
    """Variants whose arithmetic matches the policy.

    vpu policies have exactly the plain-fp32 data flow; mxu policies can run
    any of the three word data flows, which differ in movement only (the
    results are bitwise equal), so the tuner is free to pick among them.
    """
    if policy.backend == "vpu":
        return ("vpu",)
    if policy.word_dtype == "int8":
        return ("fused",)         # no staged int8 data flow
    if policy.n_words == 1:
        return ("fused",)         # one word: nothing to stage
    return ("fused", "staged", "staged_db")


def matmul_candidates(m: int, n: int, k: int, policy: TcecPolicy, *,
                      chip: Optional[ChipSpec] = None,
                      variants: Optional[Sequence[str]] = None
                      ) -> List[MatmulCandidate]:
    """Feasible (block, variant) candidates for an (m, k) @ (k, n) site."""
    chip = chip or active_chip()
    budget = staging_budget_bytes(chip)
    if variants is None:
        variants = matmul_variants(policy)
    if chip.cuda:
        return [MatmulCandidate(tile, variant) for variant in variants
                for tile in TILES
                if matmul_tile_footprint(*tile, policy.n_words, variant,
                                         chip) <= budget]
    bm_cap, bn_cap, bk_cap = derive_block_caps(chip, policy.n_words)
    bms = _axis_options(m, SUBLANE, bm_cap)
    bns = _axis_options(n, LANE, bn_cap)
    bks = _axis_options(k, LANE, bk_cap)
    out = []
    for variant in variants:
        for bm in bms:
            for bn in bns:
                for bk in bks:
                    fp = matmul_tile_footprint(bm, bn, bk, policy.n_words,
                                               variant, chip)
                    if fp <= budget:
                        out.append(MatmulCandidate((bm, bn, bk), variant))
    return out
