"""Roofline algebra for the TCEC matmul family — the part the tuner reads.

Counterpart of ``repro.core.roofline`` (kernel-block level only: chip
specs, staging budget, tile footprints, block caps and the predicted
matmul time).  The cluster roofline, ``paper_eq1_ai``,
``tcec_attainable_tflops`` and ``bf_ratio`` are not ported: nothing on the
ported paths reads them.

Two kinds of spec.  The TPU and the paper's GPU specs (``tpu-v5e``,
``a100-sxm4``, ``v100-sxm2``) keep the reference's rules bit for bit, so
the port's analytic tuner can be held against the reference's.  A spec with
``cuda=True`` (the H100) describes the port's own CUDA kernels: its
footprint is the shared memory each kernel asks for per block, its budget
the per-block limit, and its tiles the compiled menu
(``repro_torch.kernels._build.TILES``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    matrix_tflops: float          # peak matrix-unit TFLOP/s (bf16/fp16)
    vector_tflops: float          # peak fp32 vector-unit TFLOP/s
    hbm_gbps: float               # HBM bandwidth GB/s
    staging_gbps: float           # staging tier bandwidth GB/s (SMEM agg / VMEM)
    staging_kib: float            # staging capacity per core (KiB)
    ici_gbps_per_link: float = 0.0
    hbm_gib: float = 16.0
    #: The port's CUDA kernels run on this chip: footprints are their shared
    #: memory per block and the budget is ``block_smem_kib``.
    cuda: bool = False
    block_smem_kib: float = 0.0   # shared memory one block may use (KiB)


# Hardware constants from the assignment (+ paper Table 1 for context).
TPU_V5E = ChipSpec(
    name="tpu-v5e", matrix_tflops=197.0, vector_tflops=197.0 / 4,
    hbm_gbps=819.0, staging_gbps=22_000.0, staging_kib=128 * 1024,
    ici_gbps_per_link=50.0, hbm_gib=16.0,
)
A100_SXM4 = ChipSpec(
    name="a100-sxm4", matrix_tflops=312.0, vector_tflops=19.5,
    hbm_gbps=1555.0, staging_gbps=19_491.0, staging_kib=164,
)
V100_SXM2 = ChipSpec(
    name="v100-sxm2", matrix_tflops=112.0, vector_tflops=15.7,
    hbm_gbps=900.0, staging_gbps=14_131.0, staging_kib=96,
)
# NVIDIA H100 SXM5, from NVIDIA's published figures:
#   989 TFLOP/s dense bf16, 67 TFLOP/s fp32 (non-tensor), 3.35 TB/s HBM3,
#   80 GB — the H100 data sheet,
#   https://www.nvidia.com/en-us/data-center/h100/
#   132 SMs — the Hopper architecture white paper,
#   https://resources.nvidia.com/en-us-tensor-core/gtc22-whitepaper-hopper
#   228 KiB of shared memory per SM, at most 227 KiB per block — the Hopper
#   tuning guide, https://docs.nvidia.com/cuda/hopper-tuning-guide/index.html
# staging_gbps is derived, not published: 132 SMs x 128 B/clk of shared
# memory per SM x 1.98 GHz, the clock at which the 67 TFLOP/s fp32 figure is
# reached (67e12 / (132 SMs x 128 fp32 lanes x 2 flops) = 1.98e9).
H100_SXM5 = ChipSpec(
    name="h100-sxm5", matrix_tflops=989.0, vector_tflops=67.0,
    hbm_gbps=3350.0, staging_gbps=132 * 128 * 1.98, staging_kib=228,
    hbm_gib=80.0, cuda=True, block_smem_kib=227,
)

CHIPS = {c.name: c for c in (TPU_V5E, A100_SXM4, V100_SXM2, H100_SXM5)}


def active_chip() -> ChipSpec:
    """The chip the analytic models target.

    ``REPRO_CHIP`` selects any registered ``ChipSpec`` by name; the default
    is the H100, the card the port's kernels are written for.
    """
    name = os.environ.get("REPRO_CHIP")
    if not name:
        return H100_SXM5
    try:
        return CHIPS[name]
    except KeyError:
        raise KeyError(f"REPRO_CHIP={name!r} is not a registered chip; "
                       f"known: {sorted(CHIPS)}") from None


# ---------------------------------------------------------------------------
# Kernel-block-level model: footprints, caps and predicted times.
# ---------------------------------------------------------------------------

#: Slice of the staging tier one matmul's working set may claim (reference
#: rule; calibrated so the v5e reproduces its (128, 128, 512) caps).
STAGING_BUDGET_FRACTION = 1.0 / 64.0

#: Mosaic double-buffers every BlockSpec-pipelined input stream.
PIPELINE_FACTOR = 2

# MXU/VREG alignment: sublane multiple for rows, lane multiple for cols.
SUBLANE = 8
LANE = 128

MATMUL_VARIANTS = ("fused", "staged", "staged_db", "vpu")

#: Row padding (elements) of the port's shared-memory tiles, as declared in
#: ``csrc/tcec_matmul.cu`` (fp32 source tiles, ``APAD``/``BPAD``: pitches of
#: 8 and 4 words mod 32, conflict-free fragment reads) and
#: ``csrc/tcec_staged.cu`` (bf16 word tiles, ``WPAD``: 16 bytes, which keeps
#: every row 16-byte aligned for ``cp.async``); K2b's ring holds
#: ``CUDA_K2B_SLOTS`` (A, B) k tiles (``NSLOT``).
CUDA_FP32_PAD_A = 8
CUDA_FP32_PAD_B = 4
CUDA_K2B_SLOTS = 2
CUDA_WORD_PAD = 8


def staging_budget_bytes(chip: ChipSpec = None) -> int:
    """Staging-tier bytes one kernel's per-step working set may use: the
    per-block shared-memory limit on a ``cuda`` spec, the reference's slice
    of VMEM otherwise."""
    chip = chip or active_chip()
    if chip.cuda:
        return int(chip.block_smem_kib * 1024)
    return int(chip.staging_kib * 1024 * STAGING_BUDGET_FRACTION)


def matmul_tile_footprint(bm: int, bn: int, bk: int, n_words: int,
                          variant: str = "fused",
                          chip: ChipSpec = None) -> int:
    """Staging-tier bytes of one tile's working set (paper Fig. 6).

    On a ``cuda`` spec: the shared memory a block of the port's kernel asks
    for.  ``fused`` (K2b) and ``vpu`` stage the fp32 source tiles (a ring
    of ``CUDA_K2B_SLOTS``) and keep the words and the accumulator in
    registers; ``staged`` (K5) stages all ``2 * n_words`` bf16 word tiles;
    ``staged_db`` (K6) two slots of them.

    Otherwise the reference's rule: ``fused``/``vpu`` stream the fp32 source
    blocks (double-buffered by Mosaic), ``staged`` ``n_words`` bf16 word
    buffers per input, ``staged_db`` an explicit two-slot scratch of them,
    and every variant keeps a (bm, bn) fp32 accumulator resident.
    """
    if variant not in MATMUL_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{MATMUL_VARIANTS}")
    chip = chip or active_chip()
    if chip.cuda:
        if variant in ("fused", "vpu"):
            return CUDA_K2B_SLOTS * 4 * (bm * (bk + CUDA_FP32_PAD_A)
                                         + bk * (bn + CUDA_FP32_PAD_B))
        p = CUDA_WORD_PAD
        words = n_words * 2 * (bm * (bk + p) + bk * (bn + p))
        return words if variant == "staged" else 2 * words
    in_elems = bm * bk + bk * bn
    if variant in ("fused", "vpu"):
        in_bytes = PIPELINE_FACTOR * 4 * in_elems
    elif variant == "staged":
        in_bytes = PIPELINE_FACTOR * (2 * n_words) * in_elems
    else:  # staged_db: two explicit slots of all word buffers
        in_bytes = 2 * (2 * n_words) * in_elems
    return in_bytes + 4 * bm * bn


#: Per-SM limits of an sm_90 card that bound resident blocks (CUDA
#: programming guide, "Technical Specifications per Compute Capability"):
#: shared memory per SM and reserved per block, threads, blocks, and the
#: register file — four processing blocks of 16384 registers each (Hopper
#: white paper), every warp's registers (in units of 256) taken from one.
SM90_SMEM_PER_SM = 228 * 1024
SM90_SMEM_RESERVED_PER_BLOCK = 1024
SM90_THREADS_PER_SM = 2048
SM90_BLOCKS_PER_SM = 32
SM90_SUBPARTITIONS = 4
SM90_REGS_PER_SUBPARTITION = 16384
SM90_REG_ALLOC_UNIT = 256


def resident_blocks(smem_bytes: int, threads: int, regs_per_thread: int) -> int:
    """Blocks of one kernel that fit on an sm_90 SM at once: the least of
    the shared-memory, thread, register and block-count limits."""
    by_smem = SM90_SMEM_PER_SM // (smem_bytes + SM90_SMEM_RESERVED_PER_BLOCK)
    warps = -(-threads // 32)
    unit = SM90_REG_ALLOC_UNIT
    regs_per_warp = max(unit, -(-regs_per_thread * 32 // unit) * unit)
    warps_by_regs = SM90_SUBPARTITIONS * (SM90_REGS_PER_SUBPARTITION
                                          // regs_per_warp)
    return min(by_smem, SM90_THREADS_PER_SM // threads,
               warps_by_regs // warps, SM90_BLOCKS_PER_SM)


def derive_block_caps(chip: ChipSpec = None,
                      n_words: int = 3) -> Tuple[int, int, int]:
    """(bm_cap, bn_cap, bk_cap) tile caps derived from the chip (reference
    rule; read by the tuner's TPU-spec search space).

    bm/bn: the paper's B/F crossover — the smallest square blocking whose
    AI(n) = n/5 reaches the staging-vs-matrix ratio, rounded up to the lane
    width.  bk: the largest power-of-two multiple of the lane width whose
    worst-case (``staged``) footprint at (bm_cap, bn_cap, bk) fits the
    staging budget.  On the v5e this yields (128, 128, 512).
    """
    chip = chip or active_chip()
    ai_star = chip.matrix_tflops * 1000.0 / chip.staging_gbps
    n_star = max(1, int(-(-5 * ai_star // 1)))        # AI(n) = n/5 crossover
    cap_mn = max(LANE, -(-n_star // LANE) * LANE)
    budget = staging_budget_bytes(chip)
    bk_cap = LANE
    while True:
        nxt = bk_cap * 2
        if matmul_tile_footprint(cap_mn, cap_mn, nxt, n_words,
                                 "staged", chip) > budget:
            break
        bk_cap = nxt
    return cap_mn, cap_mn, bk_cap


def _pad_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


#: Fixed per-grid-step and per-launch overheads (seconds) — the reference's
#: analytic constants, deterministic across processes by construction.
GRID_STEP_OVERHEAD_S = 2e-8
LAUNCH_OVERHEAD_S = 2e-6


def predict_matmul_time(m: int, n: int, k: int, *, batch: int = 1,
                        block: Tuple[int, int, int], variant: str = "fused",
                        passes: int = 6, n_words: int = 3,
                        rhs_batched: bool = True,
                        chip: ChipSpec = None) -> float:
    """Roofline-predicted seconds for the batched TCEC matmul (the
    reference's model, term for term).

    Three terms over the *padded* problem:

      * matrix-unit time — ``passes`` passes per logical matmul (``vpu``:
        one fp32 pass on the vector unit);
      * HBM time — A re-streamed per n-tile, B per m-tile, C written once
        (staged variants move ``n_words`` bf16 words per input element and
        pay one extra pass to materialize them);
      * staging time — bytes through the staging tier per the variant's
        data flow (fused reads the fp32 source once; staged writes and
        reads back every split word).

    ``staged`` serializes the word round-trip against the passes
    (t_mxu + t_stage); ``fused``/``staged_db``/``vpu`` overlap copy with
    compute (max of terms).
    """
    chip = chip or active_chip()
    bm, bn, bk = block
    mp, np_, kp = _pad_up(m, bm), _pad_up(n, bn), _pad_up(k, bk)
    flops = 2.0 * batch * mp * np_ * kp
    if variant == "vpu":
        t_mxu = flops / (chip.vector_tflops * 1e12)
    else:
        t_mxu = flops * passes / (chip.matrix_tflops * 1e12)

    in_bytes_elem = 4.0 if variant in ("fused", "vpu") else 2.0 * n_words
    b_batch = batch if rhs_batched else 1
    hbm = (batch * mp * kp * in_bytes_elem * (np_ // bn)
           + b_batch * kp * np_ * in_bytes_elem * (mp // bm)
           + batch * mp * np_ * 4.0)
    if variant in ("staged", "staged_db"):
        # Host-side split materialization: read fp32 source, write the words.
        hbm += (batch * mp * kp + b_batch * kp * np_) * (4.0 + 2.0 * n_words)
    t_hbm = hbm / (chip.hbm_gbps * 1e9)

    stage_in_elem = 4.0 if variant in ("fused", "vpu") else 2.0 * (2 * n_words)
    stage = (batch * mp * kp * stage_in_elem * (np_ // bn)
             + b_batch * kp * np_ * stage_in_elem * (mp // bm)
             # fp32 accumulator read+write per k step of every output tile
             + batch * mp * np_ * 8.0 * (kp // bk))
    t_stage = stage / (chip.staging_gbps * 1e9)

    steps = batch * (mp // bm) * (np_ // bn) * (kp // bk)
    t_over = LAUNCH_OVERHEAD_S + steps * GRID_STEP_OVERHEAD_S
    if variant == "staged":
        return max(t_hbm, t_mxu + t_stage) + t_over
    return max(t_hbm, t_mxu, t_stage) + t_over
