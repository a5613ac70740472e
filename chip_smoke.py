#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Run from the repository root:

    python3 chip_smoke.py

It imports nothing of JAX or of the ``repro`` package.  It

  0. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     ``sm_90a``, one compiler per library and pass count, all started
     together);
  1. holds each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (K3 also at a long prefill of 2048 positions
     and at head dims 128 and 256, each row with its plan, passes, emulated
     TFLOP/s and fp32 SDPA with ``enable_gqa`` beside it; K4 also at
     a long context its plan splits and at every head-dim bucket, with the
     plan and passes each row ran, timed through its wrapper and as the
     enqueue alone; the non-finite fix-up against its plain version with
     the flag set and ±inf/NaN in its inputs at the tied LM head's serving
     shape and two more, and its cost with the flag set and clear) — the
     TCEC matmuls (K2, K2b, K5, K6) also
     against an fp64 oracle, K2 also at ragged shapes under every pair of
     operand dtypes and twice for the same bits, with the plan it ran
     (tile, k splits), the passes it ran and a digest of each result; K2's
     ``frag=`` arm (K2f: the rhs made from a menu rule in registers) at
     ``K2F_SHAPES`` under bf16x1/x3/x6, bitwise K2 on the rule built as a
     bf16 tensor, with its shared memory per block beside K2's, then
     through ``tcec.einsum`` (its path: ``"pallas_fragment"`` recorded, no
     ``build()`` call, counters zeroed before and read after), timed beside
     K2 on the built rhs, fp32 ``torch.matmul`` and ``torch.cumsum``; and
     K2b, K5 and K6 bitwise
     against each other over the whole tile menu — and times kernel, plain
     version and a PyTorch library call (a yardstick the port never calls)
     with CUDA events (K2 also with the L2 cache flushed before each call,
     as the decode tick finds its weights);
  2. serves qwen2-0.5b at full width (24 layers, random bf16 weights from a
     seed) through ``PagedServingEngine`` under ``bf16x6_pallas``, checks
     the launch counters and every request's output, then serves the same
     stream under ``bf16x6`` (the same split schedule as torch ops, no
     kernel), compares prefill logits between the two paths (on the bf16
     weights, and on the same model widened to fp32 weights, where the
     paths differ only in fp32 summation order), measures how far a mere
     change of summation order moves the twin's logits on the bf16 weights
     (the witness the bf16 limit is set from) and how both gaps grow with
     depth, and profiles three decode ticks of the kernel path (device
     time by kernel, K2's and K4's shares, the device's idle share); it
     checks that no non-finite guard reads the device from the host on a
     decode tick (the guard-sync counter stays 0), and runs one more tick
     under torch's sync debug mode to list every host sync left and where
     it comes from (none may come from the model code, nor from the engine
     but its token transfer); then it times the
     first tick, which prefills every prompt, and profiles it (K3's device
     time per prefill);
  3. drives ``tcec_matmul_auto`` under ``REPRO_TUNE=measure`` (fresh plan
     cache under ``build/``) over the paper's batched-SGEMM sweep, a 4096^3
     product and qwen2-0.5b's w_gate at prefill: the chosen (variant, tile),
     every variant's best time, cuBLAS SGEMM's, the bounds, a cache hit on
     a second plan, each variant's call time minus its kernel time, a
     default (analytic) call's time around its kernel on its first call and
     once its plan is kept, and each kernel's shared memory and blocks per
     SM against the port's footprint model;
  4. drives the structured ops ``repro_torch.kernels.ops.householder``,
     ``givens`` and ``cumsum`` (K7-K9: H, G and the triangular ones made in
     registers) at the paper's benchmark shapes and at one shape per op
     that fills the card (the scan also at block_n 8192), checks them
     against their plain versions and the JAX tests' properties, holds each
     kernel against its plain version at the JAX tests' shapes and a ragged
     one, checks the bf16-overflow ±inf/NaN pattern, and times kernel,
     plain version and the staged library flow (``torch.bmm`` of the
     materialized matrix in bf16, and in fp32 with TF32 off, the one call
     that computes the kernel's function, beside a device copy of A; for
     the scan fp32 ``torch.cumsum``).

Any failed check exits non-zero.  It prints the card's name and power limit,
a ``{"kernels": [...]}`` line (``launches``: host calls of the kernel's
wrapper on its path, one per call; ``enqueues``: what one call puts on the
stream), and as its last line
``{"ok": true, "device": {...}}``.  Full tables go to
``build/chip_smoke.json``.  ``--parity-only`` stops after phase 1 and prints
no result line (driving an earlier tree through ``--src``, it skips K2f
where that tree has no ``frag=`` arm); so do ``--k2f-only`` (K2's library
built alone, what ``ptxas -v`` says of K2 with the ``frag=`` arm's
instantiations marked, and K2f's phase-1 rows and path), ``--k3-only``
(K3 alone: what ``ptxas -v`` says of
each instantiation, its phase-1 rows and the probes of ``K3_PROBES``),
``--k2b-only`` (K2b alone: what ``ptxas -v`` says of K2b, K5 and K6, and
K2b at every shape of ``k2b_shapes()``, bitwise against K5 and K6 at every
tile, with every kernel's time at every tile), ``--k5-only`` (the same for
K5 at every shape of ``k5_shapes()`` under the bf16 policies; it fails if
``ptxas -v`` reports a spill in K5), ``--k6-only`` (the same with K6 as the
focus; it fails if ``ptxas -v`` reports a spill in K6), ``--k9-only``
(K9 alone: the structured library built alone, what ``ptxas -v`` says of it
(it fails on a spill in K9), K9 at every shape of ``K9_SHAPES`` held
against its plain version with a digest of each result, timed beside fp32
``torch.cumsum``, a device copy of x and its bound), ``--k7-only`` (the
same for K7 and K8 at every shape of ``K7_SHAPES``, timed beside fp32 and
bf16 ``torch.bmm`` of the materialized matrix, a device copy of A and the
bound; it fails on a spill in ``rule_apply_kernel``) and
``--profile-only`` (phase 2's profiles alone).  ``--src DIR`` drives the
``repro_torch`` package under DIR instead of this checkout's, so an earlier
commit's tree, unpacked, is measured by the same code.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate and fp32 rate outside the tensor cores (the paper's "FP32
# SIMT" line).  Bounds below are derived from these, not measured.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

#: The repo's fp64-oracle bounds of the TCEC matmuls (max-norm error).
ORACLE_TOL = {"bf16x1": 1e-2, "bf16x3": 1e-4, "bf16x6": 2e-6,
              "fp32_vpu": 1e-5}
SEED = 0
N_NEW = 32
PAGE = 16
SLOTS = 4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_rel(x, ref) -> float:
    """max |x - ref| / max |ref| (the repository's max-norm error)."""
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / (ref.abs().max() + 1e-300))


def bound_ms(n_bytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, queued: bool = True, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events around
    each call).  With ``queued`` the calls are enqueued behind a sleeping
    kernel so host overhead does not show up as device time; ``fn`` must
    then not synchronise.  ``flush`` (see ``l2_flush``) runs before each
    call, outside the events, so the call finds the L2 cache cold."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if queued:
        torch.cuda._sleep(200_000_000)
    for s, e in ev:
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in ev)
    return ts[len(ts) // 2]


def l2_flush(dev):
    """A function that reads 256 MB (five times the H100's 50 MB L2) on
    the current stream, so what a call reads next comes from HBM, as the
    decode tick's weights do (24 layers stream ≈ 715 MB per tick)."""
    import torch
    buf = torch.ones(64 << 20, dtype=torch.float32, device=dev)
    return lambda: buf.sum()


def on_grid(x, gen):
    """Values on a 1/8 grid in [-1, 1], in ``x``'s shape, dtype and device.
    Under bf16x1 attention rounds P to one bf16 word, so fp32 scores that
    differ in summation order alone could round a P to the neighbouring
    word; on the grid every score is exact in fp32 whatever the order, and
    the kernel and its plain version round the same P (ROADMAP Queue 3
    D2).  The CPU tests use the same grid."""
    import torch
    return (torch.randint(-8, 9, x.shape, generator=gen, device=x.device)
            / 8.0).to(x.dtype)


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

#: K2's layer shapes (k, n) in phase 1, with the lhs dtype, bias and
#: activation the qwen2 path gives them under bf16x6_pallas.
K2_LAYERS = {(896, 896): ("wo", "float32", False, None),
             (896, 128): ("wk/wv", "bfloat16", True, None),
             (896, 4864): ("w_gate", "bfloat16", False, "silu"),
             (4864, 896): ("w_down", "bfloat16", False, None)}
K2_M = (4, 256)
K2_POLICIES = ("bf16x1", "bf16x3", "bf16x6")
K2_HEADLINE = (4, 896, 4864, "bf16x6")
#: Ragged K2 shapes (m, k, n): m of 1, 3 and 17, n not a multiple of 8, k
#: not a multiple of 16; each under every dtype pair of lhs and weights.
K2_RAGGED = ((1, 200, 100), (3, 905, 131), (17, 72, 250))


def k2_inputs(dev, gen, m, k, n, a_dt, has_bias):
    """Seeded operands of a K2 layer row: fp32 (a32, b32) for the fp64
    oracle, and the path's (x, w, bias) with bf16 weights."""
    import torch
    a32 = torch.randn(m, k, generator=gen, device=dev)
    b32 = torch.randn(k, n, generator=gen, device=dev)
    w = (torch.randn(k, n, generator=gen, device=dev)
         / k ** 0.5).to(torch.bfloat16)
    x = torch.randn(m, k, generator=gen, device=dev).to(getattr(torch, a_dt))
    bias = (torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
            if has_bias else None)
    return a32, b32, w, x, bias


def same_bits(x, y) -> bool:
    import torch
    return x.dtype == y.dtype and torch.equal(
        x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16
                            else torch.int32),
        y.contiguous().view(torch.int16 if y.dtype == torch.bfloat16
                            else torch.int32))


def k2_times(dev, tm, pol, x, w, kw, flush):
    """K2's device time at warm L2 (the weights cached by the previous
    call, the way the other kernels are timed) and cold (L2 flushed before
    each call, as on the decode tick), its plan, and two library times on
    the same operands: fp32 ``torch.matmul`` (the same function, but it
    reads the bf16 weights widened to fp32, twice K2's bytes) and bf16
    ``torch.matmul`` with fp32 accumulate (K2's weight bytes; the lhs
    rounded to bf16 where it is fp32, which is less work than K2's)."""
    import torch
    _, _, launch = tm.launcher(x, w, pol, **kw)
    a_lib, b_lib = x.float(), w.float()
    a_bf = x.to(torch.bfloat16)
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        bf16_ms = time_ms(lambda: torch.matmul(a_bf, w))
    finally:
        mm.allow_bf16_reduced_precision_reduction = reduced
    return dict(ms=time_ms(launch), cold_ms=time_ms(launch, flush=flush),
                library_ms=time_ms(lambda: torch.matmul(a_lib, b_lib)),
                library_bf16_ms=bf16_ms, plan=launch.plan)


def check_k2(dev, rows, flush):
    """K2 at phase 1's layer shapes x m in {4, 256} under every policy:
    fp32 operands against the fp64 oracle, the path's dtypes and epilogue
    against the plain version (1e-5 max-norm), the same bits on a second
    call; each row's plan (tile, splits, blocks) and the passes it runs,
    checked against the count the library was built to run; times.  Then
    the ragged shapes under every dtype pair, and non-finite inputs."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import tcec_matmul as tm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    headline = None
    for m in K2_M:
        for (k, n), (layer, a_dt, has_bias, act) in K2_LAYERS.items():
            a32, b32, w, x, bias = k2_inputs(dev, gen, m, k, n, a_dt,
                                             has_bias)
            oracle = (a32.double() @ b32.double())
            for name in K2_POLICIES:
                pol = get_policy(name)
                # fp32 operands: accuracy against the fp64 oracle.
                got = tm.tcec_matmul_fused(a32, b32, pol)
                digests = [digest(got)]
                err_o = max_rel(got, oracle)
                if err_o >= ORACLE_TOL[name]:
                    fail(f"K2 {name} m={m} k={k} n={n}: fp64-oracle error "
                         f"{err_o:.3e} >= {ORACLE_TOL[name]:.0e}")
                err_p32 = max_rel(got, tm.tcec_matmul_plain(a32, b32, pol))
                same = same_bits(got, tm.tcec_matmul_fused(a32, b32, pol))
                # The path's dtypes and epilogue: against the plain version.
                kw = dict(bias=bias, activation=act)
                got = tm.tcec_matmul_fused(x, w, pol, **kw)
                digests.append(digest(got))
                same = same and same_bits(got, tm.tcec_matmul_fused(
                    x, w, pol, **kw))
                plain = tm.tcec_matmul_plain(x, w, pol, **kw)
                err_p = max(max_rel(got, plain), err_p32)
                if err_p >= 1e-5:
                    fail(f"K2 {name} m={m} k={k} n={n}: kernel vs plain "
                         f"{err_p:.3e} >= 1e-5")
                if not same:
                    fail(f"K2 {name} m={m} k={k} n={n}: two calls gave "
                         f"different bits")
                run = tm.k2_passes(pol, x.dtype, w.dtype)
                lib, fn = tm._entry("repro_tcec_matmul_passes_run",
                                    pol.passes)
                if fn(int(x.dtype == torch.bfloat16), 1) != len(run):
                    fail(f"K2 {name} {layer}: the library runs another "
                         f"number of passes than {run}")
                t = k2_times(dev, tm, pol, x, w, kw, flush)
                plain_ms = time_ms(
                    lambda: tm.tcec_matmul_plain(x, w, pol, **kw),
                    queued=False)
                n_bytes = (x.numel() * x.element_size()
                           + w.numel() * w.element_size() + m * n * 4
                           + (n * 2 if has_bias else 0))
                b_ms, b_by = bound_ms(n_bytes, 2.0 * m * n * k * len(run))
                plan = t["plan"]
                row = dict(kernel="tcec_matmul", layer=layer, m=m, k=k, n=n,
                           policy=name, a_dtype=a_dt, bias=has_bias,
                           activation=act, tile=plan.tile,
                           splits=plan.splits, chunk=plan.chunk,
                           blocks=plan.blocks, passes_run=[list(p)
                                                           for p in run],
                           oracle_err=err_o, max_abs_err=float(
                               (got.double() - plain.double()).abs().max()),
                           rel_err_vs_plain=err_p, bitwise_repeat=same,
                           digests=digests, ms=t["ms"], cold_ms=t["cold_ms"],
                           plain_ms=plain_ms, library_ms=t["library_ms"],
                           library_bf16_ms=t["library_bf16_ms"],
                           bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(f"K2 {layer:7s} m={m:3d} k={k:4d} n={n:4d} {name}: "
                      f"{plan.tile} x{plan.splits} ({plan.blocks} blocks), "
                      f"passes {run} | oracle {err_o:.2e} plain {err_p:.2e}"
                      f" repeat bitwise | {t['ms']:.4f} ms, cold L2 "
                      f"{t['cold_ms']:.4f} (plain {plain_ms:.4f}, fp32 "
                      f"matmul {t['library_ms']:.4f}, bf16 matmul "
                      f"{t['library_bf16_ms']:.4f}, bound {b_ms:.4f} "
                      f"{b_by}) | digests {'/'.join(digests)}", flush=True)
                if (m, k, n, name) == K2_HEADLINE:
                    headline = row
    rows.append(dict(kernel="tcec_matmul", layer="ragged",
                     digests=check_k2_ragged(dev, gen)))
    return headline


def check_k2_ragged(dev, gen):
    """K2 at the ragged shapes under every dtype pair and policy, with an
    epilogue: within 1e-5 of the plain version (fp32 out; a bf16 store is
    the cast of the kernel's fp32 result, bit for bit), the fp64 oracle on
    fp32 operands, the same bits on a second call; then non-finite inputs
    give the plain version's ±inf/NaN pattern.  Returns a digest of each
    result, by (shape, dtypes, policy)."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import tcec_matmul as tm
    bf, f32 = torch.bfloat16, torch.float32
    #: (lhs, weights, bias dtype, activation, residual dtype, out dtype)
    combos = ((bf, bf, bf, "gelu", f32, bf), (f32, bf, None, "silu", None,
                                              None),
              (bf, f32, f32, "relu", bf, None), (f32, f32, None, None, None,
                                                 None))
    n_checked, digests = 0, {}
    for m, k, n in K2_RAGGED:
        for a_dt, w_dt, bias_dt, act, res_dt, out_dt in combos:
            x = torch.randn(m, k, generator=gen, device=dev).to(a_dt)
            w = torch.randn(k, n, generator=gen, device=dev).to(w_dt)
            kw = dict(
                bias=None if bias_dt is None else torch.randn(
                    n, generator=gen, device=dev).to(bias_dt),
                residual=None if res_dt is None else torch.randn(
                    m, n, generator=gen, device=dev).to(res_dt),
                activation=act, out_dtype=out_dt)
            oracle = x.double() @ w.double()
            for name in K2_POLICIES:
                pol = get_policy(name)
                got = tm.tcec_matmul_fused(x, w, pol, **kw)
                kw32 = dict(kw, out_dtype=None)
                got32 = tm.tcec_matmul_fused(x, w, pol, **kw32)
                err = max_rel(got32, tm.tcec_matmul_plain(x, w, pol, **kw32))
                # A bf16 store is the RNE cast of the kernel's own fp32
                # result, bit for bit (the plain version's fp32 result
                # differs in summation order, so its cast may differ by
                # one bf16 ulp).
                cast = got32.to(out_dt) if out_dt is not None else got32
                if err >= 1e-5 or not same_bits(got, cast) or not same_bits(
                        got, tm.tcec_matmul_fused(x, w, pol, **kw)):
                    fail(f"K2 ragged {name} ({m}, {k}, {n}) {a_dt}/{w_dt}: "
                         f"kernel vs plain {err:.3e} (limit 1e-5), store "
                         f"cast {same_bits(got, cast)}, repeat bitwise")
                if a_dt == w_dt == f32 and max_rel(
                        tm.tcec_matmul_fused(x, w, pol), oracle) \
                        >= ORACLE_TOL[name]:
                    fail(f"K2 ragged {name} ({m}, {k}, {n}): fp64 oracle")
                n_checked += 1
                digests[f"{m}x{k}x{n} {str(a_dt)[6:]}/{str(w_dt)[6:]} "
                        f"{name}"] = digest(got.float())
    # Non-finite values in the fp32 lhs, then in bf16 weights (both halves
    # of a packed pair) against a bf16 lhs, at decode and prefill tiles:
    # plans with splits (the fix-up folded into the reduce kernel) and, at
    # k = 16 (one k step), with one split (the fix-up kernel on its own).
    splits_seen = set()
    for m, a_dt, k in ((3, f32, 905), (40, bf, 905), (40, f32, 16)):
        x = torch.randn(m, k, generator=gen, device=dev).to(a_dt)
        w = torch.randn(k, 136, generator=gen, device=dev).to(bf)
        if a_dt == f32:
            x[1, 2], x[2, 5] = float("inf"), float("nan")
        else:
            w[7, 4], w[7, 5], w[900, 130] = (float("inf"), float("-inf"),
                                             float("nan"))
        for name in K2_POLICIES:
            pol = get_policy(name)
            splits_seen.add(tm.launcher(x, w, pol)[2].plan.splits > 1)
            got = tm.tcec_matmul_fused(x, w, pol, activation="tanh")
            plain = tm.tcec_matmul_plain(x, w, pol, activation="tanh")
            if bool(torch.isfinite(plain).all()) or not same_nonfinite(
                    got, plain):
                fail(f"K2 {name} m={m}: non-finite inputs give another "
                     f"pattern than the plain version's")
    if splits_seen != {True, False}:
        fail("K2 non-finite checks did not cover one split and splits")
    print(f"K2 ragged: {n_checked} (shape, dtypes, policy) rows within "
          f"tolerance of the plain version and the same bits twice; "
          f"non-finite inputs give the plain version's ±inf/NaN pattern "
          f"(fix-up folded into the reduce and on its own); digests "
          f"{' '.join(digests.values())}", flush=True)
    return digests


#: K2's frag= arm (K2f): name -> (lhs shape, lhs dtype, menu rule and its
#: arguments, epilogue, non-finite lhs values as (row, column, value)).
#: The reference's cumsum block; the prefill tile at 64 MB in and out; the
#: decode tile with k splits and the whole epilogue; a band with a
#: residual; a 3-D lhs whose rows are not 16-byte multiples (element
#: copies); ±inf and NaN in the lhs (the guarded policies only).
K2F_SHAPES = {
    "cumsum_4096x256": ((4096, 256), "float32", ("triangular", 256), {},
                        ()),
    "prefill_16384x1024": ((16384, 1024), "float32", ("triangular", 1024),
                           {}, ()),
    "decode_4x896": ((4, 896), "bfloat16", ("identity", 896),
                     dict(bias=True, activation="silu",
                          out_dtype="bfloat16"), ()),
    "banded_288x4864": ((288, 4864), "float32", ("banded", 4864, 3, 1),
                        dict(residual=True), ()),
    "unaligned_3x37x45": ((3, 37, 45), "float32",
                          ("triangular", 45, False, True), {}, ()),
    "nonfinite_64x256": ((64, 256), "float32", ("triangular", 256), {},
                         ((1, 3, float("inf")), (4, 255, float("-inf")),
                          (7, 0, float("nan")), (9, 100, float("inf")))),
}
K2F_HEADLINE = ("prefill_16384x1024", "bf16x6")


def k2f_operands(dev, gen, name):
    """A ``K2F_SHAPES`` row on ``dev``: (x, the rule's operand, epilogue
    keywords)."""
    import torch
    from repro_torch import tcec
    shape, a_dt, (rule, *args), ep, bad = K2F_SHAPES[name]
    x = torch.randn(*shape, generator=gen, device=dev)
    for i, j, v in bad:
        x[i, j] = v
    x = x.to(getattr(torch, a_dt))
    n = args[0]
    kw = dict(activation=ep.get("activation"),
              out_dtype=getattr(torch, ep["out_dtype"])
              if "out_dtype" in ep else None,
              bias=torch.randn(n, generator=gen, device=dev).to(
                  torch.bfloat16) if ep.get("bias") else None,
              residual=torch.randn(*shape[:-1], n, generator=gen, device=dev)
              if ep.get("residual") else None)
    op = getattr(tcec, rule)(*args, device=dev)
    return x, op, kw


def k2f_work(x, out, op, kw, passes: int):
    """(bytes, operations, the passes' operations) of a K2f call: x read
    once, the output written once, bias and residual read once (the rule
    is made in registers: no rhs bytes); per output element the fp32 adds
    that a running sum over the band needs (a triangle 1, a band of width
    w min(w - 1, 2), the identity none) and one per epilogue term (what
    the function needs, whatever computes it); and, as a figure of its
    own, the 2·m·n·k operations of each pass the arm runs."""
    m = x.numel() // x.shape[-1]
    k, n = op.shape
    extra = [t for t in (kw["bias"], kw["residual"]) if t is not None]
    n_bytes = (x.numel() * x.element_size() + out.numel() * out.element_size()
               + sum(t.numel() * t.element_size() for t in extra))
    lo, hi = op.rule.band()
    adds = 1 if lo is None or hi is None else min(hi - lo, 2)
    per_out = adds + len(extra) + int(kw["activation"] is not None)
    return n_bytes, float(per_out) * out.numel(), 2.0 * m * n * k * passes


def k2f_smem(x_dtype, tile, pol):
    """K2's shared memory per block for the frag= arm and for a loaded bf16
    (and, with an fp32 lhs, fp32) rhs at ``tile``, as the card reports."""
    import torch
    from repro_torch.kernels import tcec_matmul as tm
    rhs = [("frag", None), ("bf16", torch.bfloat16)]
    if x_dtype == torch.float32:
        rhs.append(("fp32", torch.float32))
    return {what: tm.k2_attrs(tile, x_dtype, dt, pol)
            for what, dt in rhs}


def check_k2f(dev, rows):
    """K2's frag= arm at every shape of ``K2F_SHAPES`` under bf16x1/x3/x6:
    bitwise K2 on the rule built as a bf16 (k, n) tensor, within 1e-5 of
    the plain version (a bf16 store is the cast of the arm's own fp32
    result), the plain version's ±inf/NaN
    pattern (the error is the max-norm one of K2's rows, ``max_rel``: the
    fp32 sums differ in order only); times (CUDA events, warm L2) of the
    arm, K2 on the built rhs,
    fp32 ``torch.matmul`` of the built matrix (TF32 off: the same function)
    and, beside the upper-triangular rows, ``torch.cumsum``; the bound
    (``k2f_work``: what the function needs) and the passes' operations;
    shared memory per block for both flows.  Then the path: every (shape,
    policy) through ``tcec.einsum`` under the policy's kernel variant, the
    launch counts zeroed just before and read just after, with
    ``FragmentOperand.build`` spied on: each call records
    ``"pallas_fragment"``, builds nothing, gives the arm's bits and
    launches the arm once.  Returns (the headline row, the path's
    launches)."""
    import dataclasses
    import torch
    from repro_torch import tcec
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import tcec_matmul as tm
    from repro_torch.tcec.operands import FragmentOperand
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    headline, calls, smem_seen = None, [], {}
    for name, (shape, a_dt, rule, _, bad) in K2F_SHAPES.items():
        x, op, kw = k2f_operands(dev, gen, name)
        built = op.build().to(torch.bfloat16)
        policies = ("bf16x3", "bf16x6") if bad else K2_POLICIES
        for pname in policies:
            pol = get_policy(pname)
            got = tm.tcec_matmul_fused(x, None, pol, frag=op, **kw)
            k2 = tm.tcec_matmul_fused(x, built, pol, **kw)
            kw32 = dict(kw, out_dtype=None)
            got32 = tm.tcec_matmul_fused(x, None, pol, frag=op, **kw32)
            plain = tm.tcec_matmul_plain(x, None, pol, frag=op, **kw32)
            if bad:
                err = 0.0 if same_nonfinite(got32, plain) else float("inf")
                abs_err = err
                pattern = not bool(torch.isfinite(plain).all())
            else:
                err = max_rel(got32, plain)
                abs_err = float((got32.double() - plain.double()).abs().max())
                pattern = bool(torch.isfinite(got32).all()) \
                    and bool(torch.isfinite(plain).all())
            bitwise = same_bits(got, k2)
            cast = same_bits(got, got32.to(got.dtype))
            if not (bitwise and cast and pattern) or err >= 1e-5:
                fail(f"K2f {name} {pname}: bitwise K2 on the built rhs "
                     f"{bitwise}, store cast {cast}, ±inf/NaN pattern "
                     f"{pattern}, kernel vs plain {err:.3e} (limit 1e-5)")
            calls.append((name, pname, x, op, kw, got))
            run = tm.k2_passes(pol, x.dtype, None)
            _, _, launch = tm.launcher(x, None, pol, frag=op, **kw)
            plan = launch.plan
            row = dict(kernel="tcec_matmul_frag", shape=name,
                       dims=list(shape) + [op.shape[1]], policy=pname,
                       rule=list(op.menu), lhs_dtype=a_dt,
                       nonfinite=bool(bad), tile=plan.tile,
                       splits=plan.splits, blocks=plan.blocks,
                       passes_run=[list(p) for p in run],
                       bitwise_k2_built=bitwise, max_abs_err=abs_err,
                       rel_err_vs_plain=err, digest=digest(got.float()))
            text = (f"K2f {name:20s} {pname}: {plan.tile} x{plan.splits} "
                    f"({plan.blocks} blocks), passes {run} | bitwise K2 on "
                    f"the built bf16 rhs, " + (
                        "plain's ±inf/NaN pattern" if bad else
                        f"vs plain {err:.2e} (max abs {abs_err:.3e})") +
                    f" | digest {row['digest']}")
            if not bad:
                _, _, k2_launch = tm.launcher(x, built, pol, **kw)
                a32, b32 = x.float(), built.float()
                n_bytes, flops, pass_ops = k2f_work(x, got, op, kw, len(run))
                b_ms, b_by = bound_ms(n_bytes, flops, FP32_FLOPS)
                row.update(ms=time_ms(launch), k2_built_ms=time_ms(k2_launch),
                           library_ms=time_ms(lambda: torch.matmul(a32, b32)),
                           plain_ms=time_ms(functools.partial(
                               tm.tcec_matmul_plain, x, None, pol, frag=op,
                               **kw), queued=False),
                           bound_ms=b_ms, bound_by=b_by,
                           passes_operations=pass_ops)
                text += (f" | {row['ms']:.4f} ms, K2 on the built rhs "
                         f"{row['k2_built_ms']:.4f}, fp32 matmul "
                         f"{row['library_ms']:.4f}, plain "
                         f"{row['plain_ms']:.4f}")
                if op.menu == (0, 1, 0):           # upper, not strict
                    row["cumsum_ms"] = time_ms(
                        lambda: torch.cumsum(a32, dim=-1))
                    text += f", torch.cumsum {row['cumsum_ms']:.4f}"
                text += (f", bound {b_ms:.4f} ({b_by}, "
                         f"{b_ms / row['ms']:.1%}); the passes "
                         f"{pass_ops:.3e} operations")
                key = (plan.tile, x.dtype, pname)
                if key not in smem_seen:
                    smem_seen[key] = k2f_smem(x.dtype, plan.tile, pol)
                row["attrs"] = smem_seen[key]
                text += " | smem/block " + ", ".join(
                    f"{w} {a['smem_bytes']} B ({a['blocks_per_sm']}/SM, "
                    f"{a['regs']} regs)" for w, a in row["attrs"].items())
            if (name, pname) == K2F_HEADLINE:
                headline = row
            rows.append(row)
            print(text, flush=True)
    # The path: the frontend, with the counters zeroed just before.
    built_calls = []
    orig = FragmentOperand.build
    FragmentOperand.build = lambda self: (built_calls.append(self),
                                          orig(self))[1]
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        with tcec.trace_plans() as log:
            outs = []
            for name, pname, x, op, kw, _ in calls:
                eq = "bmk,kn->bmn" if x.dim() == 3 else "mk,kn->mn"
                ep = tcec.Epilogue(bias=kw["bias"],
                                   activation=kw["activation"],
                                   residual=kw["residual"],
                                   out_dtype=kw["out_dtype"])
                pol = dataclasses.replace(get_policy(pname), kernel="pallas")
                outs.append(tcec.einsum(eq, x, op, policy=pol, epilogue=ep))
        torch.cuda.synchronize()
        launches = {c: v for c, v in launch_counts().items() if v}
    finally:
        FragmentOperand.build = orig
    if built_calls or [r.backend for r in log] != \
            ["pallas_fragment"] * len(calls) or \
            launches.get("tcec_matmul_frag") != len(calls) or \
            launches.get("tcec_matmul"):
        fail(f"K2f through tcec.einsum: records "
             f"{sorted(set(r.backend for r in log))}, {len(built_calls)} "
             f"build() calls, launches {launches}")
    for (name, pname, *_, got), out in zip(calls, outs):
        if not same_bits(out, got):
            fail(f"K2f {name} {pname}: tcec.einsum gave other bits than "
                 f"the arm")
    print(f"K2f through tcec.einsum: {len(calls)} calls, each recorded "
          f"pallas_fragment with the arm's bits, no build() call; launches "
          f"{launches}", flush=True)
    return headline, launches


#: K3's rows: name -> (b, h, kvh, sq, d, dv, causal, input dtype).
#: "headline" is qwen2-0.5b's prefill at the smoke's longest prompt; "long"
#: a prefill of 2048 positions, where the (b, h, q tile) grid alone fills
#: the card; the others the larger head dims the kernel takes.
K3_SHAPES = {"headline": (1, 14, 2, 256, 64, 64, True, "float32"),
             "long": (1, 14, 2, 2048, 64, 64, True, "float32"),
             "d128": (1, 14, 2, 256, 128, 128, True, "float32"),
             "d256": (1, 14, 2, 256, 256, 256, True, "float32")}
#: More K3 rows under ``--k3-only`` (bf16x6 alone), which tell the causes
#: of its time apart: a non-causal call (twice the pairs, every block the
#: same length), bf16 inputs (fewer words to split and passes to run), four
#: sequences (four times the blocks at the same chain length) and one q
#: tile of 64 rows (the chain of one kv tile).
K3_PROBES = {"noncausal": (1, 14, 2, 256, 64, 64, False, "float32"),
             "bf16_in": (1, 14, 2, 256, 64, 64, True, "bfloat16"),
             "b4": (4, 14, 2, 256, 64, 64, True, "float32"),
             "sq64": (1, 14, 2, 64, 64, 64, True, "float32")}


def k3_work(b, h, sq, skv, causal, d, dv, qk, pv):
    """(pairs, emulated flops, tensor-core flops) of a K3 call: the (row,
    column) pairs it must score, 2 pairs (d + dv) h b for the fp32 product
    it stands for, and the same with each contraction times its passes."""
    pairs = sum(min(skv, r + 1) for r in range(sq)) if causal else sq * skv
    return (pairs, 2.0 * pairs * (d + dv) * h * b,
            2.0 * pairs * (d * qk + dv * pv) * h * b)


def check_k3(dev, rows, shapes=None, policies=("bf16x1", "bf16x3",
                                                "bf16x6")):
    """K3 against its plain version (1e-5 max-norm; bf16x1 on a 1/8 grid)
    at each row of ``shapes`` (``K3_SHAPES`` by default) under
    ``policies``: the plan and passes each row ran, times beside the plain
    version, SDPA (``enable_gqa``; at the headline also over heads copied
    by ``repeat_interleave``, the earlier yardstick), the bound and the
    emulated TFLOP/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    headline = None
    for shape, (b, h, kvh, s, d, dv, causal, dt) in (shapes
                                                      or K3_SHAPES).items():
        dtype = getattr(torch, dt)
        normal = [torch.randn(b, n, s, e, generator=gen,
                              device=dev).to(dtype)
                  for n, e in ((h, d), (kvh, d), (kvh, dv))]
        grid = [on_grid(x, gen) for x in normal]
        for name in policies:
            pol = get_policy(name)
            q, k, v = grid if name == "bf16x1" else normal
            got = fa.flash_attention(q, k, v, causal=causal, policy=pol)
            # The plain version's fp32, in the wrapper's output dtype (bf16
            # for bf16 inputs under the uncorrected bf16x1).
            plain = fa.flash_attention_plain(q, k, v, pol, causal=causal
                                             ).to(got.dtype)
            err = max_rel(got, plain)
            if err >= 1e-5:
                fail(f"K3 {shape} {name}: kernel vs plain {err:.3e} >= 1e-5")
            ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                    policy=pol))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(
                q, k, v, pol, causal=causal), reps=3 if s > 512 else 10,
                queued=False)
            q32, k32, v32 = (x.float() for x in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q32, k32, v32, is_causal=causal, enable_gqa=True))
            lib_copy_ms = None
            if shape == "headline":
                lib_copy_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    q32, k32.repeat_interleave(h // kvh, 1),
                    v32.repeat_interleave(h // kvh, 1), is_causal=causal))
            if hasattr(fa, "k3_passes"):
                from repro_torch.kernels.tcec_matmul import plan_sms
                qk, pv = fa.k3_passes(pol, q.dtype, k.dtype)
                plan_d = dataclasses.asdict(fa.k3_plan(
                    b, h, kvh, s, s, causal, d, dv, plan_sms(dev)))
            else:                    # an earlier tree: every pass, no plan
                qk = pv = tuple(pol.schedule)
                plan_d = None
            pairs, flops, tc_flops = k3_work(b, h, s, s, causal, d, dv,
                                             len(qk), len(pv))
            n_bytes = (q.numel() + k.numel() + v.numel()) * q.element_size() \
                + b * h * s * dv * 4
            b_ms, b_by = bound_ms(n_bytes, tc_flops)
            row = dict(kernel="flash_attention", shape=shape, b=b, h=h,
                       kvh=kvh, sq=s, d=d, dv=dv, causal=causal, dtype=dt,
                       policy=name, plan=plan_d,
                       passes_qk=[list(p) for p in qk],
                       passes_pv=[list(p) for p in pv],
                       rel_err_vs_plain=err,
                       max_abs_err=float((got.float() - plain.float()).abs()
                                         .max()), ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       library_repeat_ms=lib_copy_ms, bound_ms=b_ms,
                       bound_by=b_by, emulated_tflops=flops / ms / 1e9,
                       sdpa_tflops=flops / lib_ms / 1e9)
            rows.append(row)
            copies = "" if lib_copy_ms is None else \
                f", over copied heads {lib_copy_ms:.4f}"
            print(f"K3 {shape:9s} ({b},{h},{s},{d}/{dv}) kvh{kvh} "
                  f"{'causal' if causal else 'full'} {dt} {name}: plan "
                  f"{plan_d} passes {len(qk)}+{len(pv)} | plain {err:.2e} | "
                  f"{ms:.4f} ms = {row['emulated_tflops']:.2f} emulated "
                  f"TFLOP/s (plain {plain_ms:.4f}, sdpa gqa {lib_ms:.4f} = "
                  f"{row['sdpa_tflops']:.2f} TFLOP/s{copies}, bound "
                  f"{b_ms:.4f} {b_by})", flush=True)
            if (shape, name) == ("headline", "bf16x6"):
                headline = row
    return headline


def _kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled name (a length-prefixed
    identifier ending in ``_kernel``), else the mangled name.  The length
    may follow other digits (an anonymous namespace's hash), so every
    suffix of a digit run is tried."""
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        digits = m.group(0)
        for i in range(len(digits)):
            name = mangled[m.end():m.end() + int(digits[i:])]
            if name.endswith("_kernel"):
                return name
    return mangled


def _template_args(mangled: str) -> str:
    """The integer and bool template arguments of a mangled kernel name,
    e.g. ``<6,0,64,64>``."""
    return "<" + ",".join(re.findall(r"L[ib](-?\d+)E", mangled)) + ">"


def ptxas_report(build, pattern):
    """What ``ptxas -v`` said of each kernel in the build logs matching
    ``pattern``: registers, spill stores and loads, stack and static shared
    memory, per library and kernel (the dynamic shared memory is the
    kernel's own count)."""
    out = {}
    for log in sorted(build.glob(pattern)):
        kernels, cur = [], None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = dict(kernel=m.group(1), registers=0, stack=0,
                           spill_stores=0, spill_loads=0, static_smem=0)
                kernels.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
        out[log.stem] = kernels
        for k in kernels:
            name = _kernel_name(k["kernel"])
            print(f"  {log.stem}: {k['registers']:3d} regs, spill "
                  f"{k['spill_stores']}/{k['spill_loads']} B st/ld, stack "
                  f"{k['stack']} B, static smem {k['static_smem']} B  "
                  f"{name[:40]}{_template_args(k['kernel'])}", flush=True)
    return out


#: K4's rows: name -> (seq_lens, d, dv).  "headline" is the serving shape
#: (4 slots, mixed lengths with an empty one); "long" a context of 2048
#: positions per slot, which the plan splits; the others the head dims the
#: kernels take (every bucket, and d != dv) at the headline's lengths.
K4_LENS = [0, 37, 190, 288]
K4_SHAPES = {"headline": (K4_LENS, 64, 64), "long": ([2048] * 4, 64, 64),
             "d32": (K4_LENS, 32, 32), "d128": (K4_LENS, 128, 128),
             "d256": (K4_LENS, 256, 256), "d192_dv128": (K4_LENS, 192, 128)}


def k4_bound(lens, h, kvh, d, dv, b, npages, esize, qk, pv):
    """(bound ms, what bounds it): each live position's k and v rows read
    once, q read and the fp32 output written once, the table and lengths;
    the passes K4 runs on the tensor cores."""
    live = sum(lens)
    n_bytes = (live * kvh * (d + dv) * esize + b * h * d * 4 + b * h * dv * 4
               + b * npages * 4 + b * 4)
    flops = 2.0 * live * h * (d * len(qk) + dv * len(pv))
    return bound_ms(n_bytes, flops)


def check_k4(dev, rows):
    """K4 against its plain version (1e-5 max-norm; bf16x1 on a 1/8 grid)
    at the serving shape, a long context that the plan splits and every
    head-dim bucket, bf16 pages, under every policy; a zero length gives
    zeros; times (the whole wrapper, as earlier trees timed K4, and the
    enqueue alone) beside its plain version, SDPA over the gathered cache
    and the bound, with the plan and the passes each row ran."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.policy import get_policy
    from repro_torch.serving import paged_attention as pa
    from repro_torch.serving.paged_cache import gather_pages
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    h, kvh = 14, 2
    heads = {}
    for shape, (lens, d, dv) in K4_SHAPES.items():
        b = len(lens)
        npages = -(-max(lens) // PAGE)
        n_phys = 1 + b * npages
        perm = torch.randperm(n_phys - 1, generator=gen, device=dev) + 1
        block_table = perm[:b * npages].reshape(b, npages).to(torch.int32)
        k_pages = torch.randn(n_phys, PAGE, kvh, d, generator=gen,
                              device=dev).to(torch.bfloat16)
        v_pages = torch.randn(n_phys, PAGE, kvh, dv, generator=gen,
                              device=dev).to(torch.bfloat16)
        q = torch.randn(b, h, d, generator=gen, device=dev)
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        normal = (q, k_pages, v_pages)
        grid = [on_grid(x, gen) for x in normal]
        for name in ("bf16x1", "bf16x3", "bf16x6"):
            pol = get_policy(name)
            q, k_pages, v_pages = grid if name == "bf16x1" else normal
            kv = gather_pages(k_pages, block_table).float()
            vv = gather_pages(v_pages, block_table).float()
            kk = kv.permute(0, 2, 1, 3).repeat_interleave(h // kvh, 1)
            vk = vv.permute(0, 2, 1, 3).repeat_interleave(h // kvh, 1)
            mask = (torch.arange(kv.shape[1], device=dev)[None]
                    < seq_lens[:, None])[:, None, None]
            got = pa.paged_decode_attention_kernel(
                q, k_pages, v_pages, block_table, seq_lens, policy=pol)
            plain = pa.paged_decode_attention_plain(
                q, k_pages, v_pages, block_table, seq_lens,
                scale=1.0 / d ** 0.5, policy=pol)
            if 0 in lens and not bool((got[lens.index(0)] == 0).all()):
                fail("K4: a zero-length request did not give zeros")
            err = max_rel(got, plain)
            if err >= 1e-5:
                fail(f"K4 {shape} {name}: kernel vs plain {err:.3e} >= 1e-5")
            _, launch = pa.launcher(q, k_pages, v_pages, block_table,
                                    seq_lens, 1.0 / d ** 0.5, pol)
            plan = launch.plan
            # The whole wrapper (validation, plan, allocations and the one
            # host call that enqueues the three kernels), as earlier trees
            # timed K4, and the enqueue alone.
            ms = time_ms(lambda: pa.paged_decode_attention_kernel(
                q, k_pages, v_pages, block_table, seq_lens, policy=pol))
            launch_ms = time_ms(launch)
            plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
                q, k_pages, v_pages, block_table, seq_lens,
                scale=1.0 / d ** 0.5, policy=pol), reps=5,
                queued=False)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kk, vk, attn_mask=mask))
            qk = pa.k4_passes(pol, q.dtype, k_pages.dtype)
            pv = pa.k4_passes(pol, torch.float32, v_pages.dtype)
            b_ms, b_by = k4_bound(lens, h, kvh, d, dv, b, npages, 2, qk, pv)
            row = dict(kernel="paged_attention", shape=shape, b=b, h=h,
                       kvh=kvh, d=d, dv=dv, page=PAGE, seq_lens=lens,
                       policy=name, chunks=plan.chunks, splits=plan.splits,
                       per=plan.per, blocks=plan.blocks,
                       passes_qk=[list(p) for p in qk],
                       passes_pv=[list(p) for p in pv], rel_err_vs_plain=err,
                       max_abs_err=float((got - plain).abs().max()), ms=ms,
                       launch_ms=launch_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            print(f"K4 {shape:10s} d{d}/{dv} lens {lens} {name}: plan "
                  f"{plan.splits} x {plan.per} chunks ({plan.blocks} blocks), "
                  f"passes {len(qk)}+{len(pv)} | plain {err:.2e} | {ms:.4f} "
                  f"ms wrapper, {launch_ms:.4f} ms enqueue alone (plain "
                  f"{plain_ms:.4f}, sdpa over gathered "
                  f"{lib_ms:.4f}, bound {b_ms:.4f} {b_by})", flush=True)
            if name == "bf16x6":
                heads[shape] = row
    return heads["headline"]


#: The fix-up's rows: name -> (equation, lhs shape, rhs shape, rhs is
#: stored transposed).  "tied_head" is the twin's one fix-up per decode tick
#: at the serving width: 4 slots' hidden states against qwen2-0.5b's bf16
#: embedding (151936 x 896), read transposed through its strides — 607,744
#: outputs, so the kernel's grid-stride loop runs past its first 262,144;
#: "k2b_batched" K2b's batched shape of phase 3; "ragged" dims that no tile
#: divides, a batched lhs against a shared rhs.
FIXUP_SHAPES = {
    "tied_head": ("ay,zy->az", (4, 896), (151936, 896), True),
    "k2b_batched": ("bmk,bkn->bmn", (256, 128, 128), (256, 128, 128), False),
    "ragged": ("bmk,kn->bmn", (3, 40, 72), (72, 136), False),
}


def check_fixup(dev, rows):
    """The non-finite fix-up on its own at each shape of ``FIXUP_SHAPES``
    (K2's folded and standalone forms and K2b/K5/K6 are also checked with
    their kernels).  With the flag set and ±inf/NaN in the lhs (and, but
    for the tied head's weights, in the rhs), the same ±inf/NaN pattern as
    its plain version, finite parts untouched; its time then, and its cost
    per call with the flag clear — the case every call of the serving path
    takes."""
    import torch
    from repro_torch.kernels import nonfinite as nf
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    head = None
    for shape, (eq, sa, sb, transposed) in FIXUP_SHAPES.items():
        x = torch.randn(sa, generator=gen, device=dev)
        w = torch.randn(sb, generator=gen, device=dev)
        if transposed:                 # the embedding (v, d), bf16
            w = w.to(torch.bfloat16)
        x.view(-1)[[5, x.numel() // 2, x.numel() - 7]] = torch.tensor(
            [float("inf"), float("nan"), float("-inf")], device=dev)
        if not transposed:
            w.view(-1)[[11, w.numel() // 3]] = torch.tensor(
                [float("-inf"), float("nan")], device=dev)
        set_flag = nf.nonfinite_flag(x, w)
        clear = torch.zeros(1, dtype=torch.int32, device=dev)

        def ref(a_, b_, eq=eq):
            return torch.einsum(eq, a_.float(), b_.float())

        # What the fix-up finds: the split schedule's finite result.
        out = torch.randn(ref(x, w).shape, generator=gen, device=dev)
        plain = nf.nonfinite_fixup_plain(out.clone(), x, w, set_flag, ref)
        got = nf.einsum_fixup(eq, out.clone(), x, w, set_flag)
        if not same_nonfinite(got, plain) or bool(torch.isfinite(plain).all()):
            fail(f"fix-up {shape}: another ±inf/NaN pattern than its plain "
                 f"version's")
        both = torch.isfinite(got) & torch.isfinite(plain)
        err = float((got[both] - plain[both]).abs().max())
        o = out.clone()
        ms = time_ms(lambda: nf.einsum_fixup(eq, o, x, w, clear))
        set_ms = time_ms(lambda: nf.einsum_fixup(eq, o, x, w, set_flag),
                         reps=5)
        plain_ms = time_ms(lambda: nf.nonfinite_fixup_plain(
            o, x, w, clear, ref), queued=False)
        b_ms, b_by = bound_ms(4, 0.0)          # the flag: 4 bytes read
        row = dict(kernel="nonfinite_fixup", shape=shape, equation=eq,
                   lhs=list(sa), rhs=list(sb), outputs=got.numel(),
                   flag="clear", max_abs_err=err, ms=ms, set_ms=set_ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        print(f"fix-up {shape} {eq} {list(sa)} x {list(sb)} "
              f"({got.numel()} outputs): flag set, same pattern as plain "
              f"(finite parts {err:.2e}), {set_ms:.4f} ms | flag clear "
              f"{ms:.4f} ms per call (plain {plain_ms:.4f}, bound "
              f"{b_ms:.2e} {b_by})", flush=True)
        head = head or row
    return head


#: Shapes of the tcec_matmul_auto path (phase 3) the K2b/K5/K6 checks run
#: at: name -> (lhs, rhs).  "oracle" is k = 4864, m = 256 (the fp64-oracle
#: bounds' shape); "w_gate" qwen2-0.5b's gate layer at prefill; "batched"
#: the paper's batched regime at s = 128; "ragged" a broadcast rhs with
#: dims that no tile divides; "unaligned" one whose k and n are not
#: multiples of 4, so no row of either operand after the first starts on a
#: 16-byte boundary.
FAMILY_SHAPES = {
    "oracle": ((256, 4864), (4864, 896)),
    "w_gate": ((256, 896), (896, 4864)),
    "batched": ((256, 128, 128), (256, 128, 128)),
    "ragged": ((3, 40, 72), (72, 136)),
    "unaligned": ((3, 37, 45), (45, 29)),
}
FAMILY_HEADLINE = ("batched", "bf16x6")


def family_bound(a, b, out, pol):
    """(bound ms, what bounds it) of a K2b/K5/K6 call: fp32 operands read
    once and the fp32 output written once, against the passes on the
    tensor cores (vpu: one fp32 product on the SIMT cores)."""
    n_bytes = 4 * (a.numel() + b.numel() + out.numel())
    flops = 2.0 * out.numel() * a.shape[-1]
    if pol.backend == "vpu":
        return bound_ms(n_bytes, flops, FP32_FLOPS)
    return bound_ms(n_bytes, flops * pol.passes)


def family_calls():
    """Launch counter -> the call of K2b, K5 and K6 (``fn(a, b, pol,
    tile)``)."""
    from repro_torch.kernels import tcec_matmul as tm
    return {"tcec_matmul_pallas": tm.tcec_matmul_pallas,
            "tcec_matmul_staged": tm.tcec_matmul_staged,
            "tcec_matmul_staged_db": tm.tcec_matmul_staged_db}


def family_launch(a, b, pol, kname, tile):
    """The kernel ``kname`` of the family at ``tile`` alone enqueued (no
    host split of K5/K6, no guard)."""
    from repro_torch.kernels import tcec_matmul as tm
    if kname == "tcec_matmul_pallas":
        return tm.pallas_launcher(a, b, pol, tile)[-1]
    return tm.staged_launcher(
        a, b, pol, tile, double_buffer=kname == "tcec_matmul_staged_db")[-1]


def check_family(dev, rows):
    """K2b (bf16x1/x3/x6 and fp32_vpu), K5 and K6 (bf16x1/x3/x6) against
    their plain versions (1e-5 max-norm; bf16x1 on a 1/8 grid) and an fp64
    oracle; K2b, K5 and K6 bitwise equal at every tile of the menu; a
    non-finite input gives the fp32 product's ±inf/NaN pattern.  Times each
    kernel at the default tile beside its plain version, the fp32
    ``torch.matmul`` and its bound."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcec_matmul as tm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    calls = family_calls()
    heads = {}
    for shape, (sa, sb) in FAMILY_SHAPES.items():
        a = torch.randn(sa, generator=gen, device=dev)
        b = torch.randn(sb, generator=gen, device=dev)
        ga, gb = (on_grid(x, gen) for x in (a, b))
        oracle = torch.matmul(a.double(), b.double())
        lib_ms = time_ms(lambda: torch.matmul(a, b))
        for name in ("bf16x1", "bf16x3", "bf16x6", "fp32_vpu"):
            pol = get_policy(name)
            kernels = ["tcec_matmul_pallas"] if pol.backend == "vpu" \
                else list(calls)
            # Bitwise: every kernel at every tile against K2b's default.
            base = tm.tcec_matmul_pallas(a, b, pol)
            for kname in kernels:
                for tile in _build.TILES:
                    if not torch.equal(calls[kname](a, b, pol, tile), base):
                        fail(f"{kname} {name} {shape} tile {tile}: not "
                             f"bitwise equal to K2b at the default tile")
            err_o = max_rel(base, oracle)
            if err_o >= ORACLE_TOL[name]:
                fail(f"K2b {name} {shape}: fp64-oracle error {err_o:.3e} >= "
                     f"{ORACLE_TOL[name]:.0e}")
            pa, pb = (ga, gb) if name == "bf16x1" else (a, b)
            plain = tm.tcec_matmul_plain(pa, pb, pol)
            plain_ms = time_ms(lambda: tm.tcec_matmul_plain(pa, pb, pol),
                               queued=False)
            for kname in kernels:
                got = calls[kname](pa, pb, pol)
                err_p = max_rel(got, plain)
                if err_p >= 1e-5:
                    fail(f"{kname} {name} {shape}: kernel vs plain "
                         f"{err_p:.3e} >= 1e-5")
                ms = time_ms(family_launch(a, b, pol, kname, None))
                b_ms, b_by = family_bound(a, b, got, pol)
                row = dict(kernel=kname, shape=shape, lhs=list(sa),
                           rhs=list(sb), policy=name, tile=list(
                               _build.DEFAULT_TILE), oracle_err=err_o,
                           rel_err_vs_plain=err_p, max_abs_err=float(
                               (got.double() - plain.double()).abs().max()),
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(f"{kname:21s} {shape:7s} {name:8s}: oracle "
                      f"{err_o:.2e} plain {err_p:.2e} bitwise over "
                      f"{len(_build.TILES)} tiles | {ms:.4f} ms (plain "
                      f"{plain_ms:.4f}, fp32 matmul {lib_ms:.4f}, bound "
                      f"{b_ms:.4f} {b_by})", flush=True)
                if (shape, name) == FAMILY_HEADLINE:
                    heads[kname] = row
        # Non-finite inputs: the fp32 product's ±inf/NaN pattern.
        if shape == "ragged":
            a_bad = a.clone()
            a_bad[1, 2, 3], a_bad[0, 5, 0] = float("inf"), float("nan")
            ref = torch.matmul(a_bad, b)
            for name in ("bf16x1", "bf16x3", "bf16x6", "fp32_vpu"):
                pol = get_policy(name)
                kernels = ["tcec_matmul_pallas"] if pol.backend == "vpu" \
                    else list(calls)
                plain = tm.tcec_matmul_plain(a_bad, b, pol)
                for kname in kernels:
                    got = calls[kname](a_bad, b, pol)
                    bad = ~torch.isfinite(ref)
                    if not (torch.equal(torch.isnan(got), torch.isnan(ref))
                            and torch.equal(got[bad & ~torch.isnan(ref)],
                                            ref[bad & ~torch.isnan(ref)])
                            and bool(torch.isfinite(got[~bad]).all())
                            and same_nonfinite(got, plain)):
                        fail(f"{kname} {name}: non-finite pattern differs "
                             f"from the fp32 product's or the plain "
                             f"version's")
            print("K2b/K5/K6: non-finite inputs give the fp32 product's and "
                  "the plain version's ±inf/NaN pattern under every policy "
                  "(the fix-up kernel on a device flag)", flush=True)
    return heads


# ---------------------------------------------------------------------------
# Phase 2: serve qwen2-0.5b at full width
# ---------------------------------------------------------------------------

def serve(dev, cfg, params, prompts, policy):
    """One engine run over ``prompts``; returns (outputs, info)."""
    import torch
    from repro_torch.core.context import policy_scope
    from repro_torch.core.tcec import GUARD_SYNCS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, page_size=PAGE,
                             max_concurrency=SLOTS,
                             max_seq_len=max(map(len, prompts)) + N_NEW + 1,
                             device=dev)
    for p in prompts:
        eng.submit(p, N_NEW)
    tick_ms, decode_ms, decode_syncs = [], [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with policy_scope(policy):
        while not eng.scheduler.done:
            t = time.perf_counter()
            n0 = GUARD_SYNCS.n
            plan = eng.step()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            tick_ms.append(dt)
            if plan.decode and not plan.prefill:
                decode_ms.append(dt)
                decode_syncs.append(GUARD_SYNCS.n - n0)
            if len(tick_ms) > 10 * N_NEW:
                fail(f"{policy}: engine did not drain")
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = dict(eng.scheduler.completed)
    n_tok = sum(len(v) for v in out.values())
    decode_ms.sort()
    info = dict(policy=policy, launches=counts, stats=dict(eng.stats),
                seconds=wall, tokens=n_tok, tok_per_s=n_tok / wall,
                decode_tick_ms_median=decode_ms[len(decode_ms) // 2],
                prefill_tick_ms=[t for t in tick_ms if t not in decode_ms],
                guard_syncs_per_decode_tick_max=max(decode_syncs),
                logits_finite=eng.all_logits_finite)
    return out, info


def profile_decode(dev, cfg, params, prompts, ticks: int = 3,
                   strict: bool = True):
    """Device time by kernel over ``ticks`` decode ticks of the kernel path
    (torch.profiler), and the device's busy share of the wall time; then
    one tick under torch's sync debug mode lists every host sync left.
    ``strict``: fail if one comes from the model code (ROADMAP D7) or from
    the engine other than its token transfer (D8)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.context import policy_scope
    from repro_torch.serving import PagedServingEngine
    with policy_scope("bf16x6_pallas"):
        eng = PagedServingEngine(
            cfg, params, page_size=PAGE, max_concurrency=SLOTS,
            max_seq_len=max(map(len, prompts)) + N_NEW + 1, device=dev)
        for p in prompts:
            eng.submit(p, N_NEW)
        while eng.stats["decode_ticks"] == 0:
            eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3 / ticks
    busy = sum(by_kernel.values())
    wall = wall_ms / ticks

    def by(*names):
        return sum(v for key, v in by_kernel.items()
                   if any(n in key for n in names))
    k2, k2_reduce = by("k2_kernel"), by("k2_reduce")
    k4, fixup = by("k4_scores", "k4_pv", "k4_merge"), by("nonfinite_fixup")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(f"decode tick profile ({ticks} ticks): wall {wall:.2f} ms/tick, "
          f"device busy {busy:.2f} ms/tick ({100 * busy / wall:.1f}%, idle "
          f"{100 * (1 - busy / wall):.1f}%); K2 {k2:.3f} + its reduce "
          f"{k2_reduce:.3f} ms/tick ({100 * (k2 + k2_reduce) / busy:.1f}% "
          f"of busy, {100 * (k2 + k2_reduce) / wall:.1f}% of the tick); K4 "
          f"{k4:.3f} ms/tick ({100 * k4 / busy:.1f}% of busy, "
          f"{100 * k4 / wall:.1f}% of the tick); the fix-up on its own "
          f"{fixup:.3f} ms/tick", flush=True)
    for name, ms in top:
        print(f"  {ms:8.3f} ms/tick  {name[:100]}")
    # One more tick under torch's sync debug mode: every host sync left,
    # and the line it comes from.
    import warnings
    from collections import Counter
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with policy_scope("bf16x6_pallas"):
                eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = Counter()
    for w in caught:
        # torch's own notice that the mode is a prototype is not a sync.
        if "called a synchronizing" in str(w.message):
            path = Path(w.filename)
            try:
                path = path.relative_to(ROOT)
            except ValueError:
                pass
            where[f"{path}:{w.lineno}"] += 1
    print(f"sync debug tick: {sum(where.values())} host syncs: "
          f"{dict(where)}", flush=True)
    from_models = {k: n for k, n in where.items()
                   if "repro_torch/models/" in k}
    if from_models and strict:
        fail(f"host syncs from the model code on a decode tick: {from_models}")
    # The engine's one sync is the token transfer (the reference makes it
    # too); its control copies make none (ROADMAP D8).
    import inspect
    host = getattr(PagedServingEngine, "_host_tokens", None)  # earlier trees
    tokens = range(0)
    if host is not None:
        lines, first = inspect.getsourcelines(host)
        tokens = range(first, first + len(lines))
    from_engine = {k: n for k, n in where.items()
                   if "repro_torch/serving/engine.py" in k
                   and int(k.rsplit(":", 1)[1]) not in tokens}
    if from_engine and strict:
        fail(f"host syncs from the engine other than the token transfer on "
             f"a decode tick: {from_engine}")
    return dict(wall_ms_per_tick=wall, busy_ms_per_tick=busy,
                idle_share=1 - busy / wall, k2_ms_per_tick=k2,
                k2_reduce_ms_per_tick=k2_reduce,
                k2_share_of_busy=(k2 + k2_reduce) / busy,
                k2_share_of_tick=(k2 + k2_reduce) / wall,
                k4_ms_per_tick=k4, k4_share_of_busy=k4 / busy,
                k4_share_of_tick=k4 / wall, fixup_ms_per_tick=fixup,
                sync_debug_tick=dict(where),
                engine_syncs_besides_tokens=sum(from_engine.values()),
                top_kernels_ms_per_tick=top)


#: K3's kernels by name in a profile, this tree's and earlier trees'.
K3_KERNELS = ("k3_fwd", "k3_merge", "flash_fwd_kernel")


def profile_prefill(dev, cfg, params, prompts, reps: int = 3):
    """The engine's first tick of the kernel path, which prefills every
    prompt (``SLOTS`` of them): its wall time on the host clock to a sync
    (median of ``reps`` fresh engines), and one more under torch.profiler:
    K3's device time per prefill, the tick's device busy time and idle
    share, and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.context import policy_scope
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import PagedServingEngine

    def first_tick(prof=None):
        eng = PagedServingEngine(
            cfg, params, page_size=PAGE, max_concurrency=SLOTS,
            max_seq_len=max(map(len, prompts)) + N_NEW + 1, device=dev)
        for p in prompts:
            eng.submit(p, N_NEW)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if prof is None else prof:
            eng.step()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, eng.stats["prefills"], \
            launch_counts()

    with policy_scope("bf16x6_pallas"):
        first_tick()                                   # warm up
        walls = sorted(first_tick()[0] for _ in range(reps))
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        wall, prefills, counts = first_tick(prof)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    k3 = sum(v for key, v in by_kernel.items()
             if any(n in key for n in K3_KERNELS))
    if not k3 or counts.get("flash_attention") != cfg.n_layers * prefills:
        fail(f"prefill tick: K3 not seen ({k3} ms, launches {counts})")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = dict(prefill_tick_ms_median=walls[len(walls) // 2],
               prefill_tick_ms=walls, prefills_per_tick=prefills,
               profiled_wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
               k3_ms_per_prefill=k3 / prefills,
               k3_launches_per_prefill=counts["flash_attention"] / prefills,
               top_kernels_ms=top)
    print(f"prefill tick ({prefills} prompts {list(map(len, prompts))}): "
          f"median {out['prefill_tick_ms_median']:.2f} ms over {reps} fresh "
          f"engines; profiled {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle {100 * out['idle_share']:.1f}%); K3 "
          f"{out['k3_ms_per_prefill']:.3f} ms of device time per prefill "
          f"({out['k3_launches_per_prefill']:.0f} launches)", flush=True)
    for name, ms in top:
        print(f"  {ms:8.3f} ms  {name[:100]}")
    return out


def serve_model(dev):
    """qwen2-0.5b at full width with random bf16 weights from ``SEED``, and
    the smoke's four prompts (64, 256 and two seeded lengths)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, dev)
    rs = np.random.default_rng(SEED)
    lens = [64, 256] + [int(n) for n in rs.integers(64, 257, 2)]
    prompts = [[int(t) for t in rs.integers(0, cfg.vocab, n)] for n in lens]
    return cfg, gen, params, lens, prompts


@contextlib.contextmanager
def truncated(model, cfg, n_layers: int):
    """``model`` cut to its first ``n_layers`` blocks (the same blocks, not
    copies) for the duration of the context; yields the matching config."""
    import torch
    blocks = model.blocks
    model.blocks = torch.nn.ModuleList(list(blocks)[:n_layers])
    try:
        yield dataclasses.replace(cfg, n_layers=n_layers)
    finally:
        model.blocks = blocks


def permuted(model, cfg, gen):
    """A copy of ``model`` with its d_model and d_ff channels permuted: the
    same function, whose contractions and norms over those channels sum in
    another order."""
    import torch
    dev = model.embed.device
    pd = torch.randperm(cfg.d_model, generator=gen, device=dev)
    pf = torch.randperm(cfg.d_ff, generator=gen, device=dev)
    m = copy.deepcopy(model)
    m.embed.data = m.embed.data[:, pd].contiguous()
    m.final_norm.data = m.final_norm.data[pd]
    for blk in m.blocks:
        att, ffn = blk.mixer, blk.ffn
        blk.norm1.data = blk.norm1.data[pd]
        blk.norm2.data = blk.norm2.data[pd]
        for w in (att.wq, att.wk, att.wv):
            w.data = w.data[pd].contiguous()
        att.wo.data = att.wo.data[:, pd].contiguous()
        for w in (ffn.w_gate, ffn.w_up):
            w.data = w.data[pd][:, pf].contiguous()
        ffn.w_down.data = ffn.w_down.data[pf][:, pd].contiguous()
    return m


def prefill_logits(model, cfg, prompts, policy, dev):
    """Last-position prefill logits (v,) of each prompt under ``policy``."""
    import torch
    from repro_torch.core.context import policy_scope
    from repro_torch.models import prefill
    with policy_scope(policy):
        return [prefill(model, {"tokens": torch.tensor([p], device=dev)},
                        cfg)[0][0] for p in prompts]


def logit_gap(xs, refs) -> float:
    """The largest max-norm distance over the prompts."""
    return max(max_rel(x, r) for x, r in zip(xs, refs))


def check_argmax(what, xs, refs, bound) -> None:
    """Same argmax wherever the reference's top-1/top-2 margin exceeds
    ``bound`` of its max-norm."""
    import torch
    for x, r in zip(xs, refs):
        top2 = torch.topk(r, 2).values
        if float(top2[0] - top2[1]) > bound * float(r.abs().max()) and \
                int(x.argmax()) != int(r.argmax()):
            fail(f"{what}: prefill argmax differs where the top-1/top-2 "
                 f"margin exceeds {bound:.3e}")


def check_serve(dev, results):
    import torch
    from repro_torch.core.context import policy_scope
    from repro_torch.models.model import _logits
    cfg, gen, params, lens, prompts = serve_model(dev)
    print(f"serve: qwen2-0.5b full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), prompts {lens}, {N_NEW} new tokens each, page "
          f"{PAGE}, {SLOTS} slots", flush=True)

    out_k, info_k = serve(dev, cfg, params, prompts, "bf16x6_pallas")
    st = info_k["stats"]
    per_fwd = cfg.n_layers * 7                    # wq wk wv wo gate up down
    expect = {"tcec_matmul": per_fwd * (st["prefills"] + st["decode_ticks"]),
              "flash_attention": cfg.n_layers * st["prefills"],
              "paged_attention": cfg.n_layers * st["decode_ticks"]}
    launched = {k: v for k, v in info_k["launches"].items() if v}
    # K2's reduce kernel runs once per K2 call with more than one split
    # (every decode call, some prefill calls) and carries its non-finite
    # fix-up; a call with one split enqueues the fix-up on its own, as does
    # the tied head (the twin) once per prefill and per tick.
    reduces = launched.pop("tcec_matmul_reduce", 0)
    fixups = launched.pop("nonfinite_fixup", 0)
    if launched.pop("guard_host_sync", 0) or \
            info_k["guard_syncs_per_decode_tick_max"]:
        fail(f"bf16x6_pallas: a non-finite guard read the device from the "
             f"host ({info_k['launches']['guard_host_sync']} syncs)")
    want_fixups = (expect["tcec_matmul"] - reduces + st["prefills"]
                   + st["decode_ticks"])
    if launched != expect or not 0 < reduces <= expect["tcec_matmul"] or \
            fixups != want_fixups:
        fail(f"launch counts {info_k['launches']} != expected {expect} "
             f"(and 0 < tcec_matmul_reduce <= tcec_matmul, nonfinite_fixup "
             f"== {want_fixups})")
    if sorted(out_k) != list(range(len(prompts))) or any(
            len(v) != N_NEW for v in out_k.values()):
        fail(f"bf16x6_pallas: outputs {[len(v) for v in out_k.values()]}")
    if not info_k["logits_finite"]:
        fail("bf16x6_pallas: non-finite logits")
    print(f"serve bf16x6_pallas: {info_k['tokens']} tokens in "
          f"{info_k['seconds']:.3f} s = {info_k['tok_per_s']:.1f} tok/s, "
          f"decode tick median {info_k['decode_tick_ms_median']:.2f} ms, "
          f"prefill ticks {[round(t, 2) for t in info_k['prefill_tick_ms']]} "
          f"ms, "
          f"launches {info_k['launches']} (expected); host syncs by a "
          f"non-finite guard: 0 per decode tick", flush=True)

    out_t, info_t = serve(dev, cfg, params, prompts, "bf16x6")
    if any(v for k, v in info_t["launches"].items()
           if k != "nonfinite_fixup"):
        fail(f"bf16x6 twin launched kernels other than the non-finite "
             f"fix-up, or made guard syncs: {info_t['launches']}")
    if any(len(v) != N_NEW for v in out_t.values()) \
            or not info_t["logits_finite"]:
        fail("bf16x6 twin: wrong output count or non-finite logits")
    same = sum(a == b for r in out_k for a, b in zip(out_k[r], out_t[r]))
    print(f"serve bf16x6 (twin): {info_t['tok_per_s']:.1f} tok/s, decode "
          f"tick median {info_t['decode_tick_ms_median']:.2f} ms; "
          f"{same}/{info_k['tokens']} greedy tokens equal to the kernel run",
          flush=True)

    # Prefill logits, kernel path vs twin path.  On the model widened to
    # fp32 weights the two differ in fp32 summation order only: 1e-5.  On
    # the bf16 serving weights every layer rounds its fp32 results to bf16,
    # so a last-bit fp32 difference can move a bf16 value by one ulp, and
    # such flips compound through the layers.  The limit there is set from
    # a witness measured in this run on the same weights: the twin against
    # the twin of the same model with its channels permuted (the same
    # function; only the order of its fp32 sums differs).  The kernel path
    # may differ from the twin by at most twice what that change of order
    # alone does, and is never held tighter than 2^-6.  Both gaps are also
    # read on the model cut to fewer layers.
    params32 = copy.deepcopy(params).float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    perm = permuted(params, cfg, gen)
    depth = []
    with torch.inference_mode():
        lk32 = prefill_logits(params32, cfg32, prompts, "bf16x6_pallas", dev)
        lt32 = prefill_logits(params32, cfg32, prompts, "bf16x6", dev)
        err32 = logit_gap(lk32, lt32)
        if err32 > 1e-5:
            fail(f"fp32 weights: prefill logits kernel vs twin {err32:.3e} "
                 f"> 1e-5")
        check_argmax("fp32 weights", lk32, lt32, 1e-5)
        del params32, lk32, lt32
        for n in sorted({1, cfg.n_layers // 4, cfg.n_layers // 2,
                         cfg.n_layers}):
            with truncated(params, cfg, n) as c, truncated(perm, cfg, n):
                lk = prefill_logits(params, c, prompts, "bf16x6_pallas", dev)
                lt = prefill_logits(params, c, prompts, "bf16x6", dev)
                lp = prefill_logits(perm, c, prompts, "bf16x6", dev)
            depth.append(dict(layers=n, kernel_vs_twin=logit_gap(lk, lt),
                              twin_vs_permuted_twin=logit_gap(lp, lt)))
            print(f"  bf16 weights, {n:2d} layers: prefill logits kernel vs "
                  f"twin {depth[-1]['kernel_vs_twin']:.3e}, twin vs permuted "
                  f"twin {depth[-1]['twin_vs_permuted_twin']:.3e}",
                  flush=True)
        full = depth[-1]
        bound = max(2.0 ** -6, 2.0 * full["twin_vs_permuted_twin"])
        if full["kernel_vs_twin"] > bound:
            fail(f"bf16 weights: prefill logits kernel vs twin "
                 f"{full['kernel_vs_twin']:.3e} > {bound:.3e} (twice the "
                 f"permuted-twin witness, at least 2^-6)")
        check_argmax("bf16 weights", lk, lt, bound)
        del perm
        # The tied LM head (twin under every policy) at the decode shape.
        h = torch.randn(SLOTS, 1, cfg.d_model, device=dev).to(torch.bfloat16)
        with policy_scope("bf16x6_pallas"):
            head_ms = time_ms(lambda: _logits(params, h, cfg), reps=5,
                              queued=False)
    errs = dict(fp32=err32, bf16=full["kernel_vs_twin"], bf16_bound=bound,
                bf16_witness=full["twin_vs_permuted_twin"], by_depth=depth)
    print(f"prefill logits kernel vs twin, max-norm: bf16 weights "
          f"{errs['bf16']:.3e} (bound {bound:.3e}), fp32 weights "
          f"{err32:.3e} (bound 1e-5); tied LM head twin at decode shape "
          f"{head_ms:.2f} ms", flush=True)
    profile = profile_decode(dev, cfg, params, prompts)
    prefill_profile = profile_prefill(dev, cfg, params, prompts)
    results["serve"] = dict(kernel_run=info_k, twin_run=info_t,
                            prefill_logit_err=errs, lm_head_ms=head_ms,
                            prompt_lens=lens, greedy_equal=same,
                            decode_profile=profile,
                            prefill_profile=prefill_profile)
    return info_k


# ---------------------------------------------------------------------------
# Phase 3: the tuner-dispatched TCEC matmul (tcec_matmul_auto)
# ---------------------------------------------------------------------------

#: The paper's batched-SGEMM sweep (Fig. 10; benchmarks/tcec_throughput.py):
#: batch x square s, batched rhs; one 4096^3 product; qwen2-0.5b's w_gate at
#: prefill.  name -> (batch or None, m, n, k).
SWEEP = {**{f"b{bt}_s{sz}": (bt, sz, sz, sz) for bt in (8, 64, 256)
            for sz in (32, 64, 128)},
         "sq4096": (None, 4096, 4096, 4096),
         "w_gate": (None, 256, 4864, 896)}
SWEEP_POLICY = "bf16x6"


def footprints():
    """Shared memory per block and resident blocks per SM of every
    (variant, tile) under bf16x6 as the card reports them, against the
    port's footprint model (``core.roofline``)."""
    from repro_torch.core import roofline
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcec_matmul as tm
    from repro_torch.tune import matmul_variants
    pol = get_policy(SWEEP_POLICY)
    table = []
    print(f"footprint under {SWEEP_POLICY} (card vs model):", flush=True)
    for variant in matmul_variants(pol) + ("vpu",):
        for tile in _build.TILES:
            got = tm.kernel_attrs(variant, tile, "fp32_vpu"
                                  if variant == "vpu" else pol)
            smem = roofline.matmul_tile_footprint(*tile, pol.n_words,
                                                  variant)
            blocks = roofline.resident_blocks(
                smem, _build.tile_threads(*tile[:2], variant), got["regs"])
            row = dict(variant=variant, tile=list(tile), **got,
                       model_smem_bytes=smem, model_blocks_per_sm=blocks)
            table.append(row)
            print(f"  {variant:9s} {str(tile):15s} {got['smem_bytes']:7d} B "
                  f"(model {smem:7d}), {got['threads']:3d} threads, "
                  f"{got['regs']:3d} regs, {got['blocks_per_sm']:2d} "
                  f"blocks/SM (model {blocks:2d})", flush=True)
            threads = _build.tile_threads(*tile[:2], variant)
            if (got["smem_bytes"], got["blocks_per_sm"], got["threads"]) \
                    != (smem, blocks, threads):
                fail(f"footprint of {variant} {tile}: card {got}, model "
                     f"{smem} B, {blocks} blocks/SM")
    return table


#: The kernel of each tuner variant (its launch counter's name).
VARIANT_KERNEL = {"fused": "tcec_matmul_pallas", "vpu": "tcec_matmul_pallas",
                  "staged": "tcec_matmul_staged",
                  "staged_db": "tcec_matmul_staged_db"}


def kernel_alone_us(a, b, pol, variant, tile):
    """Microseconds of ``variant``'s kernel at ``tile`` with the kernel
    alone enqueued (the host split of K5/K6 and the guard left out)."""
    return time_ms(family_launch(a, b, pol, VARIANT_KERNEL[variant], tile),
                   reps=10) * 1e3


def kernel_only_us(a, b, pol):
    """Each variant's best time over the tile menu with the kernel alone
    enqueued: the paper's comparison of data flows; and every (variant,
    tile)'s time.  Run after the path's launches are read."""
    from repro_torch.kernels import _build
    from repro_torch.tune import matmul_variants
    best, table = {}, {}
    for variant in matmul_variants(pol):
        for tile in _build.TILES:
            us = kernel_alone_us(a, b, pol, variant, tile)
            table[(variant, tuple(tile))] = us
            if us < best.get(variant, (float("inf"),))[0]:
                best[variant] = (us, list(tile))
    return best, table


def default_call_cost(a, b, pol, kernel_us):
    """A default ``tcec_matmul_auto`` call (the analytic tuner): its first
    call after ``clear_plan_cache()`` (host clock, synchronized) and the
    calls after it (CUDA events, not queued behind a sleep, so the host's
    time shows), beside the kernel alone of the (variant, tile) its plan
    runs (``kernel_us(variant, tile)``); each minus the kernel is the
    call's cost around its kernel."""
    import torch
    from repro_torch import tune
    from repro_torch.kernels.tcec_matmul import tcec_matmul_auto
    nb, (m, k), n = (a.shape[0] if a.dim() == 3 else 1), a.shape[-2:], \
        b.shape[-1]
    with tune.tune_mode("analytic"):
        tune.clear_plan_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tcec_matmul_auto(a, b, pol)
        torch.cuda.synchronize()
        first_us = (time.perf_counter() - t0) * 1e6
        call_us = time_ms(lambda: tcec_matmul_auto(a, b, pol),
                          queued=False) * 1e3
        plan = tune.matmul_plan(m, n, k, policy=pol, batch=nb,
                                rhs_batched=b.dim() == 3, site="auto")
    kern = kernel_us(plan.variant, tuple(plan.block))
    return dict(default_plan=[plan.variant, list(plan.block)],
                default_first_call_us=first_us, default_call_us=call_us,
                default_kernel_us=kern,
                default_first_call_minus_kernel_us=first_us - kern,
                default_call_minus_kernel_us=call_us - kern)


def check_auto(dev, results):
    """Drive ``tcec_matmul_auto`` over the sweep under REPRO_TUNE=measure
    with a fresh plan cache (every candidate timed: REPRO_TUNE_TOPK covers
    the space); check each result against an fp64 oracle, that a second
    plan of each shape comes from the cache with no launch, and report the
    chosen (variant, tile), every variant's best time and TFLOP/s, cuBLAS
    SGEMM's time and the bounds.  Returns the launch counts of the run."""
    import os
    import shutil
    import torch
    from repro_torch import tune
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tcec_matmul import tcec_matmul_auto
    cache = ROOT / "build" / "tune-cache"
    shutil.rmtree(cache, ignore_errors=True)
    env = {"REPRO_TUNE": "measure", "REPRO_TUNE_CACHE": str(cache),
           "REPRO_TUNE_TOPK": "64"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    tune.clear_plan_cache()
    pol = get_policy(SWEEP_POLICY)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    inputs = {}
    for name, (bt, m, n, k) in SWEEP.items():
        lead = () if bt is None else (bt,)
        inputs[name] = (torch.randn(lead + (m, k), generator=gen, device=dev),
                        torch.randn(lead + (k, n), generator=gen, device=dev))
    rows, outs = [], {}
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        for name, (a, b) in inputs.items():
            outs[name] = tcec_matmul_auto(a, b, pol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        tune.clear_plan_cache()      # the second plans come from the file
        for name, (bt, m, n, k) in SWEEP.items():
            a, b = inputs[name]
            before = launch_counts()
            plan = tune.matmul_plan(m, n, k, policy=pol, batch=bt or 1,
                                    rhs_batched=bt is not None, site="auto")
            if launch_counts() != before or plan.source != "measured" \
                    or not plan.trials:
                fail(f"phase 3 {name}: the second plan was not a cache hit")
            out = outs[name]
            err = max_rel(out, torch.matmul(a.double(), b.double()))
            if tuple(out.shape) != tuple(a.shape[:-1]) + (n,) or \
                    not bool(torch.isfinite(out).all()) or \
                    err >= ORACLE_TOL[SWEEP_POLICY]:
                fail(f"phase 3 {name}: shape {tuple(out.shape)}, fp64-oracle "
                     f"error {err:.3e}")
            flops = 2.0 * (bt or 1) * m * n * k
            best = {}
            for variant, block, us in plan.trials:
                if us < best.get(variant, (float("inf"),))[0]:
                    best[variant] = (us, list(block))
            kernel, table = kernel_only_us(a, b, pol)
            default = default_call_cost(
                a, b, pol, lambda v, t: table.get((v, t)) or
                kernel_alone_us(a, b, pol, v, t))
            sgemm_ms = time_ms(lambda: torch.matmul(a, b))
            b_ms, b_by = family_bound(a, b, out, pol)
            row = dict(shape=name, batch=bt or 1, m=m, n=n, k=k,
                       variant=plan.variant, tile=list(plan.block),
                       predicted_us=plan.predicted_us,
                       measured_us=plan.measured_us, oracle_err=err,
                       best_us={v: t for v, (t, _) in best.items()},
                       best_tile={v: bl for v, (_, bl) in best.items()},
                       tflops={v: flops / t / 1e6
                               for v, (t, _) in best.items()},
                       kernel_us={v: t for v, (t, _) in kernel.items()},
                       kernel_tile={v: bl for v, (_, bl) in kernel.items()},
                       call_minus_kernel_us={
                           v: best[v][0] - kernel[v][0] for v in best
                           if v in kernel},
                       sgemm_ms=sgemm_ms, sgemm_tflops=flops / sgemm_ms / 1e9,
                       bound_ms=b_ms, bound_by=b_by,
                       bound_tflops=flops / b_ms / 1e9,
                       simt_peak_tflops=FP32_FLOPS / 1e12, **default)
            rows.append(row)
            per = ", ".join(f"{v} {t:.1f} us {flops / t / 1e6:.2f} TF/s"
                            for v, (t, _) in sorted(best.items()))
            kper = ", ".join(f"{v} {t:.1f} us {tuple(bl)} {flops / t / 1e6:.2f}"
                             f" TF/s" for v, (t, bl) in sorted(kernel.items()))
            over = ", ".join(f"{v} {t:.1f} us" for v, t in sorted(
                row["call_minus_kernel_us"].items()))
            print(f"auto {name:7s}: chose {plan.variant} {plan.block} | "
                  f"call: {per} | kernel alone: {kper} | call minus kernel: "
                  f"{over} | cuBLAS SGEMM "
                  f"{sgemm_ms * 1e3:.1f} us {row['sgemm_tflops']:.2f} TF/s | "
                  f"bound {b_ms * 1e3:.2f} us {row['bound_tflops']:.1f} TF/s "
                  f"({b_by}), fp32 SIMT peak 67 TF/s | oracle {err:.2e} | "
                  f"cache hit | default call {default['default_plan']}: "
                  f"first {default['default_first_call_us']:.1f} us, then "
                  f"{default['default_call_us']:.1f} us, minus its kernel "
                  f"{default['default_first_call_minus_kernel_us']:.1f} / "
                  f"{default['default_call_minus_kernel_us']:.1f} us",
                  flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tune.clear_plan_cache()
    print(f"phase 3: {len(SWEEP)} shapes in {wall:.1f} s (tuning included), "
          f"launches {counts}", flush=True)
    results["auto"] = dict(rows=rows, launches=counts, seconds=wall,
                           footprint=footprints())
    return counts


#: K2b alone (``--k2b-only``): the phase-3 sweep, the phase-1 family shapes
#: and a batched lhs against one shared rhs at the paper's largest batch.
K2B_SHARED = {"b256_s128_shared": ((256, 128, 128), (128, 128))}
K2B_POLICIES = ("bf16x1", "bf16x3", "bf16x6", "fp32_vpu")
#: K5 or K6 alone (``--k5-only``, ``--k6-only``): the phase-3 sweep, the
#: unaligned family shape and the shared rhs, under the bf16 policies (K5 and
#: K6 stage bf16 words only).
K5_POLICIES = K2B_POLICIES[:3]
#: The focus of each ``--k*-only`` run: its launch counter, its label and its
#: kernel's name in ``ptxas -v``'s output (None: K2b, whose spills are
#: reported, not checked).
ALONE = {"k2b": ("tcec_matmul_pallas", "K2b", None),
         "k5": ("tcec_matmul_staged", "K5", "tcec_staged_k5_kernel"),
         "k6": ("tcec_matmul_staged_db", "K6", "tcec_staged_db_kernel")}


def k2b_shapes():
    """name -> (lhs shape, rhs shape) of every ``--k2b-only`` row."""
    shapes = {name: ((m, k), (k, n)) if bt is None else
              ((bt, m, k), (bt, k, n))
              for name, (bt, m, n, k) in SWEEP.items()}
    shapes.update(FAMILY_SHAPES)
    shapes.update(K2B_SHARED)
    return shapes


def k5_shapes():
    """name -> (lhs shape, rhs shape) of every ``--k5-only`` row."""
    shapes = {k: v for k, v in k2b_shapes().items()
              if k in SWEEP or k in K2B_SHARED}
    shapes["unaligned"] = FAMILY_SHAPES["unaligned"]
    return shapes


def staged_attrs():
    """K5's and K6's shared memory, registers, resident blocks per SM and
    local memory per thread at every tile under bf16x1/x3/x6, as the card
    reports them."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcec_matmul as tm
    rows = []
    print("K5 / K6 per tile (smem B, regs, blocks/SM, local B):", flush=True)
    for name in K5_POLICIES:
        for tile in _build.TILES:
            got = {v: tm.kernel_attrs(v, tile, name)
                   for v in ("staged", "staged_db")}
            rows += [dict(policy=name, variant=v, tile=list(tile), **a)
                     for v, a in got.items()]
            print(f"  {name:7s} {str(tile[:2]):10s} " + " | ".join(
                f"{lab} {a['smem_bytes']} {a['regs']} {a['blocks_per_sm']} "
                f"{a['local_bytes']}" for lab, a in
                zip(("K5", "K6"), got.values())), flush=True)
    return rows


def alone_checks(a, b, ga, gb, oracle, name, names, focus, shape):
    """``check_alone``'s checks of one (shape, policy); returns the
    fp64-oracle error and the error against the plain version of
    ``focus``'s default call."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels import tcec_matmul as tm
    pol = get_policy(name)
    calls = family_calls()
    torch.cuda.synchronize()
    reset_launch_counts()
    got = calls[focus](a, b, pol)
    moved = {k: n for k, n in launch_counts().items()
             if n and k in calls}
    if moved != {focus: 1}:
        fail(f"{focus} {shape} {name}: one call moved the family's "
             f"counters by {moved}")
    base = tm.tcec_matmul_pallas(a, b, pol)
    if not same_bits(got, base):
        fail(f"{focus} {name} {shape}: not bitwise equal to K2b")
    for kname in names:
        for tile in _build.TILES:
            if not same_bits(calls[kname](a, b, pol, tile), base):
                fail(f"{kname} {name} {shape} tile {tile}: not bitwise "
                     f"equal to K2b at the default tile")
    err_o = max_rel(base, oracle)
    if not err_o < ORACLE_TOL[name]:
        fail(f"{focus} {name} {shape}: fp64-oracle error {err_o:.3e}")
    pa, pb = (ga, gb) if name == "bf16x1" else (a, b)
    err_p = max_rel(calls[focus](pa, pb, pol),
                    tm.tcec_matmul_plain(pa, pb, pol))
    if not err_p < 1e-5:
        fail(f"{focus} {name} {shape}: kernel vs plain {err_p:.3e}")
    return err_o, err_p


def check_alone(dev, rows, which: str = "k2b", probe: bool = False):
    """One kernel of the batched family alone: K2b (``--k2b-only``) at
    every shape of ``k2b_shapes`` under bf16x1/x3/x6 and fp32_vpu, or K5
    (``--k5-only``) or K6 (``--k6-only``) at every shape of ``k5_shapes``
    under bf16x1/x3/x6.
    One default call moves its launch counter once (and no other of the
    family); K2b, K5 and K6 are bitwise equal at every tile of the menu;
    the focus kernel is within 1e-5 (max-norm) of its plain version
    (bf16x1 on a 1/8 grid) and within the fp64-oracle bound.  Times K2b,
    K5 and K6 with the kernel alone enqueued at every tile, fp32
    ``torch.matmul`` and the bound (CUDA events).  With ``probe`` (a copy
    of the kernel changed on purpose to tell the causes of its time apart)
    it checks nothing and times the focus kernel alone under the bf16
    policies."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcec_matmul as tm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    focus, label, _ = ALONE[which]
    staged = which != "k2b"
    shapes = k5_shapes() if staged else k2b_shapes()
    policies = K5_POLICIES if staged or probe else K2B_POLICIES
    for shape, (sa, sb) in shapes.items():
        a = torch.randn(sa, generator=gen, device=dev)
        b = torch.randn(sb, generator=gen, device=dev)
        ga, gb = (on_grid(x, gen) for x in (a, b))
        oracle = torch.matmul(a.double(), b.double())
        lib_ms = time_ms(lambda: torch.matmul(a, b))
        flops = 2.0 * oracle.numel() * a.shape[-1]
        for name in policies:
            pol = get_policy(name)
            if probe:
                names = [focus]
            elif pol.backend == "vpu":
                names = ["tcec_matmul_pallas"]
            else:
                names = list(family_calls())
            err_o = err_p = None
            if not probe:
                err_o, err_p = alone_checks(a, b, ga, gb, oracle, name, names,
                                            focus, shape)
            times = {}
            for kname in names:
                for tile in _build.TILES:
                    times.setdefault(kname, {})[str(tile[:2])] = time_ms(
                        family_launch(a, b, pol, kname, tile), reps=10) * 1e3
            best = {k: min(v.values()) for k, v in times.items()}
            default = {}
            if not probe and not staged and name == SWEEP_POLICY \
                    and shape in SWEEP:
                default = default_call_cost(
                    a, b, pol,
                    lambda v, t: times[VARIANT_KERNEL[v]][str(t[:2])])
            b_ms, b_by = family_bound(a, b, oracle, pol)
            row = dict(shape=shape, lhs=list(sa), rhs=list(sb), policy=name,
                       focus=focus, oracle_err=err_o, rel_err_vs_plain=err_p,
                       kernel_us=times, best_us=best,
                       emulated_tflops={k: flops / t / 1e6
                                        for k, t in best.items()},
                       library_us=lib_ms * 1e3, bound_us=b_ms * 1e3,
                       bound_by=b_by, **default)
            rows.append(row)
            per = " | ".join(
                f"{k.replace('tcec_matmul_', '')} "
                + " ".join(f"{t:.1f}" for t in v.values())
                for k, v in times.items())
            checked = "unchecked (probe)" if probe else \
                f"oracle {err_o:.2e} plain {err_p:.2e} bitwise"
            print(f"{label} {shape:16s} {name:8s}: {checked} | us by tile "
                  f"{[t[:2] for t in _build.TILES]}: {per} | best {label} "
                  f"{best[focus]:.1f} us = "
                  f"{row['emulated_tflops'][focus]:.2f} TF/s | "
                  f"fp32 matmul {lib_ms * 1e3:.1f} | bound {b_ms * 1e3:.2f} "
                  f"({b_by})", flush=True)
            if default:
                print(f"  default auto call {default['default_plan']}: first "
                      f"{default['default_first_call_us']:.1f} us, then "
                      f"{default['default_call_us']:.1f} us; kernel "
                      f"{default['default_kernel_us']:.1f} us; minus it "
                      f"{default['default_first_call_minus_kernel_us']:.1f} / "
                      f"{default['default_call_minus_kernel_us']:.1f} us",
                      flush=True)


# ---------------------------------------------------------------------------
# Phase 4: the structured ops (K7-K9)
# ---------------------------------------------------------------------------

#: Parity shapes: those of tests/test_kernels_structured.py plus one ragged
#: shape per op.  householder (b, m, k); givens (b, m, k, gi, gj); cumsum
#: (rows, n, block_n).
HH_PARITY = [(1, 16, 16), (4, 32, 64), (8, 64, 128), (2, 128, 128),
             (3, 20, 24)]
GV_PARITY = [(2, 16, 32, 1, 9), (8, 64, 64, 3, 60), (4, 128, 128, 0, 127),
             (3, 20, 24, 2, 11)]
CS_PARITY = [(8, 256, 128), (16, 512, 256), (8, 1024, 128), (32, 128, 128),
             (16, 16384, 8192),
             (24, 96, 48)]
#: The path's shapes: the paper's benchmarks as the JAX package defines them
#: (benchmarks/householder.py, benchmarks/givens.py) and one shape per op
#: that fills the card ("full", ≈ 270 MB of fp32 in and out).
HH_PATH = {"bench_m16": (512, 16, 64), "bench_m32": (512, 32, 64),
           "full": (16384, 32, 64)}
GV_PATH = {"bench": (1024, 32, 32, 3, 17), "full": (32768, 32, 32, 3, 17)}
CS_PATH = {"full": (4096, 8192, 256), "full_bn8192": (4096, 8192, 8192)}
BF16_OVERFLOW = 3.4e38   # finite in fp32, rounds to inf in bf16


def close(got, ref, tol: float) -> float:
    """max |got - ref| after checking |got - ref| <= tol + tol * |ref|
    elementwise (numpy's allclose at rtol = atol = tol); inf if not."""
    err = (got.double() - ref.double()).abs()
    if not bool((err <= tol + tol * ref.double().abs()).all()):
        return float("inf")
    return float(err.max()) if err.numel() else 0.0


def same_nonfinite(got, ref, tol: float = 1e-5) -> bool:
    """Same NaN positions, same ±inf values, finite parts within ``tol``
    (``close``)."""
    import torch
    inf, fin = torch.isinf(ref), torch.isfinite(ref)
    return (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(got[inf], ref[inf])
            and close(got[fin], ref[fin], tol) < float("inf"))


def structured_inputs(dev, gen):
    """Seeded inputs of every phase-4 shape, keyed by the parity shape or
    by the path shape's name."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    hh, gv, cs = {}, {}, {}
    for key, (b, m, k) in {**{s: s for s in HH_PARITY}, **HH_PATH}.items():
        v = randn(b, m)
        hh[key] = (v / v.norm(dim=-1, keepdim=True), randn(b, m, k))
    for key, (b, m, k, _, _) in {**{s: s for s in GV_PARITY},
                                 **GV_PATH}.items():
        gv[key] = (randn(b), randn(b, m, k))
    for key, (r, n, _) in {**{s: s for s in CS_PARITY}, **CS_PATH}.items():
        cs[key] = randn(r, n)
    return hh, gv, cs


def check_structured(dev, results):
    """Drive ``repro_torch.kernels.ops.householder``/``givens``/``cumsum``
    over the path's shapes with the counters zeroed just before and read
    just after; check the results against the plain versions (K7/K8 1e-5,
    K9 1e-5 max-norm) and the JAX tests' properties; then hold each kernel
    against its plain version at the JAX tests' shapes and a ragged one
    (K7/K8 1e-5, K9 1e-4), check the bf16-overflow ±inf/NaN pattern, and
    time kernel, plain version, the staged library flow (materialized H or
    G through ``torch.bmm``, in bf16 and in fp32) or ``torch.cumsum``,
    beside the bound.
    Returns (launch counts of the path run, headline rows)."""
    import torch
    from repro_torch.core import fragment
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import structured as st
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    hh, gv, cs = structured_inputs(dev, gen)
    t0 = time.perf_counter()

    # The path: every op through its public entry point, counted.
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = {("householder", s): ops.householder(*hh[s]) for s in HH_PATH}
    outs.update({("givens", s): ops.givens(*gv[s], *GV_PATH[s][3:])
                 for s in GV_PATH})
    outs.update({("cumsum", s): ops.cumsum(cs[s], CS_PATH[s][2])
                 for s in CS_PATH})
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {"householder_apply": len(HH_PATH),
              "givens_apply": len(GV_PATH), "scan_cumsum": len(CS_PATH)}
    got_counts = {k: v for k, v in counts.items() if v}
    if got_counts != expect:
        fail(f"phase 4 launch counts {got_counts} != expected {expect}")

    rows, heads = [], {}
    for (op, s), out in outs.items():
        if op == "householder":
            v, a = hh[s]
            plain = st.householder_plain(v, a)
            err = close(out, plain, 1e-5)
            norms = (out.double().norm(dim=1) / a.double().norm(dim=1) - 1
                     ).abs().max()
            prop = ("column norms kept", float(norms), float(norms) < 2e-2)
        elif op == "givens":
            (th, a), (_, m, _, gi, gj) = gv[s], GV_PATH[s]
            plain = st.givens_plain(th, a, gi, gj)
            err = close(out, plain, 1e-5)
            keep = [i for i in range(m) if i not in (gi, gj)]
            exact = torch.equal(out[:, keep],
                                a.to(torch.bfloat16).float()[:, keep])
            prop = ("untouched rows == bf16(A)", float(exact), exact)
        else:
            x, bn = cs[s], CS_PATH[s][2]
            plain = st.scan_cumsum_plain(x, bn)
            rel = max_rel(out, plain)
            err = float((out.double() - plain.double()).abs().max()) \
                if rel < 1e-5 else float("inf")
            oracle = max_rel(out, torch.cumsum(x.double(), dim=1))
            prop = ("fp64 cumsum max-norm", oracle, oracle < 2e-2)
        if err == float("inf") or not bool(torch.isfinite(out).all()) \
                or out.shape != plain.shape or not prop[2]:
            fail(f"phase 4 {op} {s}: kernel vs plain max abs {err:.3e}, "
                 f"{prop[0]} {prop[1]:.3e}, shape {tuple(out.shape)}")
        rows.append(dict(op=op, shape=s, max_abs_err=err,
                         check=prop[0], check_value=prop[1]))
    print(f"phase 4 path: {len(outs)} calls, launches {got_counts}; every "
          f"result within tolerance of its plain version", flush=True)

    # Parity at the JAX tests' shapes and a ragged shape (not counted).
    for b, m, k in HH_PARITY:
        v, a = hh[(b, m, k)]
        if close(st.householder_apply(v, a), st.householder_plain(v, a),
                 1e-5) == float("inf"):
            fail(f"K7 ({b}, {m}, {k}): kernel vs plain beyond 1e-5")
    for b, m, k, gi, gj in GV_PARITY:
        th, a = gv[(b, m, k, gi, gj)]
        got = st.givens_apply(th, a, gi, gj)
        keep = [r for r in range(m) if r not in (gi, gj)]
        if close(got, st.givens_plain(th, a, gi, gj), 1e-5) == float("inf") \
                or not torch.equal(got[:, keep],
                                   a.to(torch.bfloat16).float()[:, keep]):
            fail(f"K8 ({b}, {m}, {k}, {gi}, {gj}): kernel vs plain beyond "
                 f"1e-5 or untouched rows not bf16(A)")
    for r, n, bn in CS_PARITY:
        x = cs[(r, n, bn)]
        got = st.scan_cumsum(x, bn)
        if close(got, st.scan_cumsum_plain(x, bn), 1e-4) == float("inf") \
                or max_rel(got, torch.cumsum(x.double(), dim=1)) >= 2e-2:
            fail(f"K9 ({r}, {n}, {bn}): kernel vs plain beyond 1e-4 or "
                 f"fp64 cumsum beyond 2e-2")
    # bf16 overflow at the ragged shapes
    v, a = (t.clone() for t in hh[HH_PARITY[-1]])
    a[0, 4, 7], a[0, 6, 7], a[1, 9, 0] = (BF16_OVERFLOW, -BF16_OVERFLOW,
                                          BF16_OVERFLOW)
    th, (gi, gj) = gv[GV_PARITY[-1]][0], GV_PARITY[-1][3:]
    x, bn = cs[CS_PARITY[-1]].clone(), CS_PARITY[-1][2]
    x[1, 5], x[3, 40] = BF16_OVERFLOW, -BF16_OVERFLOW
    for name, got, plain in (
            ("K7", st.householder_apply(v, a), st.householder_plain(v, a)),
            ("K8", st.givens_apply(th, a, gi, gj),
             st.givens_plain(th, a, gi, gj)),
            ("K9", st.scan_cumsum(x, bn), st.scan_cumsum_plain(x, bn))):
        if bool(torch.isfinite(plain).all()) or not same_nonfinite(got,
                                                                   plain):
            fail(f"{name}: bf16 overflow gives another ±inf/NaN pattern "
                 f"than the plain version's")
    print(f"phase 4 parity: K7 {len(HH_PARITY)}, K8 {len(GV_PARITY)}, K9 "
          f"{len(CS_PARITY)} shapes within tolerance; bf16 overflow gives "
          f"the plain version's ±inf/NaN pattern", flush=True)

    # Timings (kernel alone, CUDA events).
    bf = torch.bfloat16
    timed = [("householder_apply", s, HH_PATH[s]) for s in HH_PATH] + \
        [("givens_apply", s, GV_PATH[s]) for s in GV_PATH] + \
        [("scan_cumsum", s, CS_PATH[s]) for s in CS_PATH]
    for (kname, s, shape), row in zip(timed, rows):
        if kname == "householder_apply":
            v, a = hh[s]
            b, m, k = shape
            _, launch = st.householder_launcher(v, a)
            plain = functools.partial(st.householder_plain, v, a)
            make = (lambda: fragment.householder(v).to(bf))
            make32 = (lambda: fragment.householder(v))
            n_bytes = 4 * (v.numel() + 2 * a.numel())
            flops = 2.0 * b * m * m * k
        elif kname == "givens_apply":
            th, a = gv[s]
            b, m, k, gi, gj = shape
            _, launch = st.givens_launcher(th, a, gi, gj)
            plain = functools.partial(st.givens_plain, th, a, gi, gj)
            make = (lambda: st.givens_matrices(th, m, gi, gj).to(bf))
            make32 = (lambda: st.givens_matrices(th, m, gi, gj))
            n_bytes = 4 * (th.numel() + 2 * a.numel())
            flops = 2.0 * b * m * m * k
        else:
            x = cs[s]
            r, n, bn = shape
            _, launch = st.scan_launcher(x, bn)
            plain = functools.partial(st.scan_cumsum_plain, x, bn)
            make = None
            n_bytes, flops, xu_ops = k9_work(r, n, bn)
        ms = time_ms(launch)
        plain_ms = time_ms(plain, queued=False)
        fp32_ms = copy_ms = None
        if make is None:
            lib = "torch.cumsum fp32"
            lib_ms = time_ms(lambda: torch.cumsum(x, dim=1))
            make_ms = None
            b_ms, b_by = bound_ms(n_bytes, flops, FP32_FLOPS)
        else:
            # bf16 beside fp32 (TF32 off, set in main): only the fp32 call
            # computes the kernel's function, fp32 A in and fp32 out.
            lib = "torch.bmm bf16 (materialized)"
            mat, a_bf = make(), a.to(bf)
            lib_ms = time_ms(lambda: torch.bmm(mat, a_bf))
            mat32 = make32()
            fp32_ms = time_ms(lambda: torch.bmm(mat32, a))
            make_ms = time_ms(make)
            dst = torch.empty_like(a)
            copy_ms = time_ms(lambda: dst.copy_(a))  # the same bytes moved
            b_ms, b_by = bound_ms(n_bytes, flops)
        row.update(kernel=kname, dims=list(shape), ms=ms, plain_ms=plain_ms,
                   library=lib, library_ms=lib_ms,
                   library_fp32_ms=fp32_ms, materialize_ms=make_ms,
                   copy_ms=copy_ms, bound_ms=b_ms, bound_by=b_by,
                   launches=counts[kname])
        if make is None:
            row["xu_operations"] = xu_ops
        print(f"{kname:17s} {s:9s} {str(shape):24s}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f}, {lib} {lib_ms:.4f}"
              + ("" if make_ms is None else f" + materialize {make_ms:.4f}")
              + ("" if fp32_ms is None else
                 f", torch.bmm fp32 (TF32 off) {fp32_ms:.4f}, a copy of A "
                 f"{copy_ms:.4f}")
              + f", bound {b_ms:.4f} {b_by}"
              + ("" if make is not None else
                 f"; the reference's x·U would be {xu_ops:.3e} operations")
              + ("; launch cost sets this shape's time"
                 if s.startswith("bench") else "") + f") | {row['check']} {row['check_value']:.3e}",
              flush=True)
        if s == "full":
            heads[kname] = row
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)
    results["structured"] = dict(rows=rows, launches=got_counts)
    return counts, heads


def k9_work(rows: int, n: int, block_n: int):
    """(bytes, operations, x·U operations) of a cumsum of (rows, n): x read
    once and the result written once, one add per element (what the
    function needs, whatever computes it); and, as a figure of its own, the
    2·rows·n·block_n operations of the reference's x·U product."""
    return 4.0 * 2 * rows * n, float(rows) * n, 2.0 * rows * n * block_n


#: K9 alone (``--k9-only``): name -> (rows, n, block_n, non-finite values
#: as (row, column, value)).  The path's shapes, the parity shapes (the
#: ragged (24, 96, 48) among them) and block_n 8192 with non-finite values
#: (K9's slots are 128 columns wide): an inf at column 200, whose zero
#: triangle covers the first two slots, one in a later slot of the same
#: row, a bf16-overflowing finite value, a NaN, a -inf at a block's last
#: column; and the same shape finite, to time the non-finite arm.
K9_NONFINITE = [(1, 200, float("inf")), (1, 3000, float("inf")),
                (2, 8192 + 5000, -3.4e38), (5, 100, float("nan")),
                (6, 16383, float("-inf")), (9, 4095, float("inf"))]
K9_SHAPES = {**{name: (*shape, None) for name, shape in CS_PATH.items()},
             **{f"parity_{r}x{n}_bn{bn}": (r, n, bn, None)
                for r, n, bn in CS_PARITY},
             "nonfinite_bn8192": (64, 16384, 8192, K9_NONFINITE),
             "finite_bn8192": (64, 16384, 8192, None)}


def digest(out) -> str:
    """sha256 (first 16 hex digits) of an fp32 result's bits with -0 taken
    as +0 and every NaN as one NaN."""
    import hashlib
    import torch
    y = torch.where(out == 0, torch.zeros_like(out), out)
    y = torch.where(torch.isnan(y), torch.full_like(y, float("nan")), y)
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]


def check_k9(dev, rows, probe: bool = False):
    """K9 alone at every shape of ``K9_SHAPES`` through ``scan_launcher``
    (which every tree of the port has): one launch moves its counter once;
    the result is within 1e-4 of the plain version (numpy's allclose at
    rtol = atol = 1e-4) with the plain version's ±inf/NaN pattern, or
    exactly its pattern with non-finite inputs; prints each result's
    digest; times the kernel alone (CUDA events), fp32 ``torch.cumsum``, a
    device copy of x (the same bytes moved) and the plain version beside
    the bound.  With ``probe`` it checks nothing
    and times the path's shapes and the non-finite pair only."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import structured as st
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    for name, (r, n, bn, bad) in K9_SHAPES.items():
        x = torch.randn(r, n, generator=gen, device=dev)
        for i, j, v in bad or ():
            x[i, j] = v
        timed = name in CS_PATH or name.endswith("_bn8192")
        if probe and not timed:
            continue
        out, launch = st.scan_launcher(x, bn)
        torch.cuda.synchronize()
        reset_launch_counts()
        launch()
        torch.cuda.synchronize()
        moved = {k: c for k, c in launch_counts().items() if c}
        plain = st.scan_cumsum_plain(x, bn)
        if bad:
            err = 0.0 if same_nonfinite(out, plain, 1e-4) else float("inf")
        else:
            err = close(out, plain, 1e-4)
        row = dict(shape=name, dims=[r, n, bn], nonfinite=bool(bad),
                   max_abs_err=err, digest=digest(out), launches=moved)
        if not probe and (moved != {"scan_cumsum": 1} or err == float("inf")
                          or (not bad and not bool(torch.isfinite(out).all()))
                          or (bad and bool(torch.isfinite(plain).all()))):
            fail(f"K9 {name} {(r, n, bn)}: launches {moved}, kernel vs plain "
                 f"{err:.3e}")
        text = f"K9 {name:28s} {str((r, n, bn)):20s}: " + (
            "unchecked (probe)" if probe else
            "plain's ±inf/NaN pattern" if bad else f"max abs {err:.3e}") \
            + f" | digest {row['digest']}"
        if timed:
            n_bytes, flops, xu_ops = k9_work(r, n, bn)
            b_ms, b_by = bound_ms(n_bytes, flops, FP32_FLOPS)
            row.update(ms=time_ms(launch),
                       cumsum_ms=time_ms(lambda: torch.cumsum(x, dim=1)),
                       copy_ms=time_ms(lambda: out.copy_(x)),
                       plain_ms=time_ms(functools.partial(
                           st.scan_cumsum_plain, x, bn), queued=False),
                       bound_ms=b_ms, bound_by=b_by, xu_operations=xu_ops)
            text += (f" | {row['ms']:.4f} ms, fp32 torch.cumsum "
                     f"{row['cumsum_ms']:.4f}, a copy of x "
                     f"{row['copy_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                     f"bound {b_ms:.4f} ({b_by}, {b_ms / row['ms']:.0%}); "
                     f"the reference's x·U {xu_ops:.3e} operations")
        rows.append(row)
        print(text, flush=True)


#: K7/K8 alone (``--k7-only``): name -> (op, batch, m, k, gi, gj, non-finite
#: values of A as (batch, row, column, value), of v as (batch, row,
#: value)).  The path's shapes (timed), the parity shapes, and the edges of
#: the kernel's work items: M of 20, 144 and 272 (M > 128: row groups and
#: k slabs of 128 rows), K of 3 (4-byte copies), 36 and 1000 (column
#: slices), batch 1 and 37, K8 with gi and gj in different row tiles; ±inf
#: and NaN in A at a row tile's edge, in a second column slice and in a
#: later slab, a finite v whose products overflow, a bf16-overflowing A.
#: ``unaligned`` shapes run on a contiguous view at storage offset 1.
K7_NONFINITE = {
    "hh_nonfinite_tile_edge": ("hh", 37, 20, 300, 0, 0,
                               [(1, 15, 7, float("inf")),
                                (1, 16, 200, float("nan")),
                                (2, 19, 299, float("-inf"))], []),
    "hh_nonfinite_slab": ("hh", 2, 272, 40, 0, 0,
                          [(0, 200, 35, float("inf")),
                           (1, 127, 3, float("nan"))], []),
    "hh_v_overflow": ("hh", 4, 32, 64, 0, 0, [], [(1, 7, 3.4e38)]),
    "hh_bf16_overflow": ("hh", 3, 20, 24, 0, 0,
                         [(0, 4, 7, BF16_OVERFLOW), (0, 6, 7, -BF16_OVERFLOW),
                          (1, 9, 0, BF16_OVERFLOW)], []),
    "gv_nonfinite_row_groups": ("gv", 37, 144, 40, 5, 140,
                                [(0, 15, 3, float("inf")),
                                 (2, 130, 39, float("nan"))], []),
    "gv_bf16_overflow": ("gv", 3, 20, 24, 2, 11,
                         [(0, 4, 7, BF16_OVERFLOW), (1, 9, 0, -BF16_OVERFLOW)],
                         []),
}
K7_SHAPES = {
    **{f"hh_{n}": ("hh", *shape, 0, 0, [], []) for n, shape in HH_PATH.items()},
    **{f"gv_{n}": ("gv", *shape, [], []) for n, shape in GV_PATH.items()},
    **{f"hh_parity_{b}x{m}x{k}": ("hh", b, m, k, 0, 0, [], [])
       for b, m, k in HH_PARITY},
    **{f"gv_parity_{b}x{m}x{k}": ("gv", b, m, k, gi, gj, [], [])
       for b, m, k, gi, gj in GV_PARITY},
    "hh_b37_m20_k36": ("hh", 37, 20, 36, 0, 0, [], []),
    "hh_b1_m20_k3": ("hh", 1, 20, 3, 0, 0, [], []),
    "hh_b1_m144_k1000": ("hh", 1, 144, 1000, 0, 0, [], []),
    "hh_b37_m144_k36": ("hh", 37, 144, 36, 0, 0, [], []),
    "hh_b37_m272_k3": ("hh", 37, 272, 3, 0, 0, [], []),
    "hh_b1_m272_k1000": ("hh", 1, 272, 1000, 0, 0, [], []),
    "gv_b37_m20_k36": ("gv", 37, 20, 36, 3, 17, [], []),
    "gv_b1_m272_k1000": ("gv", 1, 272, 1000, 5, 260, [], []),
    "gv_b37_m144_k3": ("gv", 37, 144, 3, 140, 2, [], []),
    "hh_unaligned_b37_m20_k36": ("hh", 37, 20, 36, 0, 0, [], []),
    "gv_unaligned_b9_m32_k64": ("gv", 9, 32, 64, 3, 17, [], []),
    **K7_NONFINITE,
}


def k7_inputs(dev, gen, op, b, m, k, bad, vbad, unaligned):
    """Seeded operands of a ``K7_SHAPES`` row: (v or theta, A) on ``dev``,
    A a contiguous view at storage offset 1 where ``unaligned``."""
    import torch
    if unaligned:
        a = torch.randn(b * m * k + 1, generator=gen, device=dev)[1:].view(
            b, m, k)
    else:
        a = torch.randn(b, m, k, generator=gen, device=dev)
    for bi, i, j, val in bad:
        a[bi, i, j] = val
    if op == "hh":
        v = torch.randn(b, m, generator=gen, device=dev)
        v = v / v.norm(dim=-1, keepdim=True)
        for bi, i, val in vbad:
            v[bi, i] = val
        return v, a
    return torch.randn(b, generator=gen, device=dev), a


def check_k7(dev, rows, probe: bool = False):
    """K7 and K8 alone at every shape of ``K7_SHAPES`` through
    ``householder_launcher``/``givens_launcher`` (which every tree of the
    port has): one launch moves its counter once; the result is within
    1e-5 of the plain version (numpy's allclose at rtol = atol = 1e-5), or
    has exactly its ±inf/NaN pattern with non-finite inputs; K8's untouched
    rows equal bf16(A) on finite inputs; prints each result's digest; at
    the path's shapes times the kernel alone (CUDA events, warm L2), the
    materialized matrix through fp32 ``torch.bmm`` (TF32 off: the kernel's
    function) and bf16 ``torch.bmm``, a device copy of A (the same bytes
    moved) and the plain version beside the bound.  With ``probe`` it
    checks nothing and runs the path's shapes only."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import structured as st
    from repro_torch.core import fragment
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    bf = torch.bfloat16
    for name, (op, b, m, k, gi, gj, bad, vbad) in K7_SHAPES.items():
        timed = name.startswith(("hh_bench", "hh_full", "gv_bench",
                                 "gv_full"))
        x, a = k7_inputs(dev, gen, op, b, m, k, bad, vbad,
                         "unaligned" in name)
        if probe and not timed:
            continue
        if op == "hh":
            out, launch = st.householder_launcher(x, a)
            plain_fn = functools.partial(st.householder_plain, x, a)
            kname = "householder_apply"
        else:
            out, launch = st.givens_launcher(x, a, gi, gj)
            plain_fn = functools.partial(st.givens_plain, x, a, gi, gj)
            kname = "givens_apply"
        torch.cuda.synchronize()
        reset_launch_counts()
        launch()
        torch.cuda.synchronize()
        moved = {c: n for c, n in launch_counts().items() if n}
        plain = plain_fn()
        nonfinite = bool(bad or vbad)
        if nonfinite:
            err = 0.0 if same_nonfinite(out, plain, 1e-5) else float("inf")
        else:
            err = close(out, plain, 1e-5)
        kept = None
        if op == "gv" and not nonfinite:
            keep = [r for r in range(m) if r not in (gi, gj)]
            kept = torch.equal(out[:, keep], a.to(bf).float()[:, keep])
        row = dict(shape=name, op=op, dims=[b, m, k, gi, gj],
                   nonfinite=nonfinite, max_abs_err=err, digest=digest(out),
                   launches=moved, untouched_rows_bf16=kept,
                   aligned=a.data_ptr() % 16 == 0)
        if not probe and (moved != {kname: 1} or err == float("inf")
                          or kept is False
                          or (not nonfinite
                              and not bool(torch.isfinite(out).all()))
                          or (nonfinite
                              and bool(torch.isfinite(plain).all()))):
            fail(f"K7/K8 {name} {(b, m, k)}: launches {moved}, kernel vs "
                 f"plain {err:.3e}, untouched rows bf16(A) {kept}")
        text = f"{'K7' if op == 'hh' else 'K8'} {name:28s} " \
            f"{str((b, m, k)):18s}: " + (
                "unchecked (probe)" if probe else
                "plain's ±inf/NaN pattern" if nonfinite else
                f"max abs {err:.3e}") + (
            "" if kept is None else f", untouched rows bf16(A) {kept}") \
            + f" | digest {row['digest']}"
        if timed:
            mat32 = fragment.householder(x) if op == "hh" else \
                st.givens_matrices(x, m, gi, gj)
            b_ms, b_by = bound_ms(4 * (x.numel() + 2 * a.numel()),
                                  2.0 * b * m * m * k)
            mat, a_bf = mat32.to(bf), a.to(bf)
            row.update(ms=time_ms(launch),
                       bmm_fp32_ms=time_ms(lambda: torch.bmm(mat32, a)),
                       bmm_bf16_ms=time_ms(lambda: torch.bmm(mat, a_bf)),
                       copy_ms=time_ms(lambda: out.copy_(a)),
                       plain_ms=time_ms(plain_fn, queued=False),
                       bound_ms=b_ms, bound_by=b_by)
            text += (f" | {row['ms']:.4f} ms, fp32 torch.bmm "
                     f"{row['bmm_fp32_ms']:.4f}, bf16 torch.bmm "
                     f"{row['bmm_bf16_ms']:.4f}, a copy of A "
                     f"{row['copy_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                     f"bound {b_ms:.4f} ({b_by}, {b_ms / row['ms']:.0%})")
        rows.append(row)
        print(text, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parity-only", action="store_true",
                    help="build and run phase 1 only; no result line")
    ap.add_argument("--k2f-only", action="store_true",
                    help="build K2's library alone, print what ptxas says "
                         "of K2 (the frag= arm's instantiations marked) and "
                         "run K2's frag= arm at the shapes of K2F_SHAPES "
                         "and through tcec.einsum; no result line")
    ap.add_argument("--k3-only", action="store_true",
                    help="build K3 alone, print what ptxas says of it, run "
                         "its phase-1 rows and the probes of K3_PROBES; no "
                         "result line")
    ap.add_argument("--k2b-only", action="store_true",
                    help="build K2b, K5/K6 and the fix-up alone, print what "
                         "ptxas says of K2b and K6, and run K2b alone at the "
                         "shapes of k2b_shapes(); no result line")
    ap.add_argument("--k5-only", action="store_true",
                    help="build K2b, K5/K6 and the fix-up alone, print what "
                         "ptxas says of K5 and K6, and run K5 alone at the "
                         "shapes of k5_shapes(); no result line")
    ap.add_argument("--k6-only", action="store_true",
                    help="build K2b, K5/K6 and the fix-up alone, print what "
                         "ptxas says of K5 and K6, and run K6 alone at the "
                         "shapes of k5_shapes(); no result line")
    ap.add_argument("--k9-only", action="store_true",
                    help="build the structured library alone, print what "
                         "ptxas says of K9 (fails on a spill) and run K9 "
                         "alone at the shapes of K9_SHAPES: checks, digests, "
                         "times; no result line")
    ap.add_argument("--k7-only", action="store_true",
                    help="build the structured library alone, print what "
                         "ptxas says of K7/K8 (fails on a spill) and run K7 "
                         "and K8 alone at the shapes of K7_SHAPES: checks, "
                         "digests, times; no result line")
    ap.add_argument("--probe", action="store_true",
                    help="with --k2b-only, --k5-only, --k6-only, --k7-only "
                         "or --k9-only: time that kernel alone (K2b/K5/K6 under "
                         "the bf16 policies) and check nothing (for a copy "
                         "of the kernel changed on purpose, driven through "
                         "--src)")
    ap.add_argument("--profile-only", action="store_true",
                    help="build, then profile the serving path alone: three "
                         "decode ticks with the sync-debug tick (reported, "
                         "not checked) and the first tick's prefills; no "
                         "result line")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the directory holding the repro_torch package to "
                         "drive (default: this checkout's src), e.g. an "
                         "earlier commit's unpacked tree, to measure it with "
                         "this script")
    args = ap.parse_args(argv)
    src = args.src.resolve()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import _build
    if args.k2f_only:
        _build.LIBS = {"tcec_matmul": _build.LIBS["tcec_matmul"]}
    if args.k3_only:
        _build.LIBS = {"flash_attention": _build.LIBS["flash_attention"]}
    if args.k9_only or args.k7_only:
        _build.LIBS = {"structured": _build.LIBS["structured"]}
    which = "k2b" if args.k2b_only else "k5" if args.k5_only else \
        "k6" if args.k6_only else None
    if which:
        keep = ("tcec_staged",) if which != "k2b" and args.probe else (
            "tcec_matmul_k2b", "tcec_staged", "nonfinite_fixup")
        _build.LIBS = {k: _build.LIBS[k] for k in keep}
    t_start = t0 = time.perf_counter()
    build = _build.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s -> {build}",
          flush=True)
    seconds = json.loads((build / "build_seconds.json").read_text()) \
        if (build / "build_seconds.json").exists() else {}
    build_info = {}
    for log in sorted(build.glob("*.log")):
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        build_info[log.stem] = dict(seconds=seconds.get(log.stem),
                                    max_registers=max(regs, default=0),
                                    spill_bytes=spill)
        print(f"  {log.stem}: {seconds.get(log.stem)} s, {len(regs)} "
              f"kernels, max {max(regs, default=0)} registers/thread, "
              f"{spill} bytes of spill traffic in all")

    results = {"card": card, "torch": torch.__version__, "src": str(src),
               "build": build_info, "k3_build": ptxas_report(
                   build, "libflash_attention_p*.log")}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    if args.profile_only:
        cfg, _, params, _, prompts = serve_model(dev)
        dec = profile_decode(dev, cfg, params, prompts, strict=False)
        pre = profile_prefill(dev, cfg, params, prompts)
        summary = dict(
            decode={k: dec[k] for k in ("wall_ms_per_tick", "busy_ms_per_tick",
                                        "idle_share", "sync_debug_tick",
                                        "engine_syncs_besides_tokens")},
            prefill={k: v for k, v in pre.items() if k != "top_kernels_ms"})
        print(json.dumps(summary), flush=True)
        print("profile-only: passed", file=sys.stderr)
        return 0
    if which:
        _, label, kernel_name = ALONE[which]
        if which == "k2b":
            print("ptxas -v of K2b:", flush=True)
            results["k2b_build"] = ptxas_report(
                build, "libtcec_matmul_k2b_p*.log")
        print("ptxas -v of K5 and K6:", flush=True)
        results["staged_build"] = ptxas_report(build, "libtcec_staged_p*.log")
        spills = [f"{lib}: {_kernel_name(k['kernel'])}"
                  f"{_template_args(k['kernel'])}"
                  for lib, ks in results["staged_build"].items() for k in ks
                  if _kernel_name(k["kernel"]) == kernel_name and
                  k["spill_stores"] + k["spill_loads"]]
        if spills and not args.probe:
            fail(f"{label} spills: {spills}")
        if which != "k2b":
            results["staged_attrs"] = staged_attrs()
        rows = []
        check_alone(dev, rows, which, args.probe)
        results[which] = rows
        (out_dir / f"chip_smoke_{which}.json").write_text(
            json.dumps(results, indent=1))
        print(f"{which}-only: passed in "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr)
        return 0
    if args.k9_only:
        print("ptxas -v of K7-K9:", flush=True)
        results["k9_build"] = ptxas_report(build, "libstructured_p*.log")
        spills = [f"{_kernel_name(k['kernel'])}{_template_args(k['kernel'])}"
                  for ks in results["k9_build"].values() for k in ks
                  if _kernel_name(k["kernel"]) == "scan_kernel"
                  and k["spill_stores"] + k["spill_loads"]]
        if spills and not args.probe:
            fail(f"K9 spills: {spills}")
        rows = []
        check_k9(dev, rows, args.probe)
        results["k9"] = rows
        (out_dir / "chip_smoke_k9.json").write_text(
            json.dumps(results, indent=1))
        print(f"k9-only: passed in {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr)
        return 0
    if args.k7_only:
        print("ptxas -v of K7-K9:", flush=True)
        results["k7_build"] = ptxas_report(build, "libstructured_p*.log")
        spills = [f"{_kernel_name(k['kernel'])}{_template_args(k['kernel'])}"
                  for ks in results["k7_build"].values() for k in ks
                  if _kernel_name(k["kernel"]) == "rule_apply_kernel"
                  and k["spill_stores"] + k["spill_loads"]]
        if spills and not args.probe:
            fail(f"K7/K8 spill: {spills}")
        rows = []
        check_k7(dev, rows, args.probe)
        results["k7"] = rows
        (out_dir / "chip_smoke_k7.json").write_text(
            json.dumps(results, indent=1))
        print(f"k7-only: passed in {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr)
        return 0
    if args.k2f_only:
        print("ptxas -v of K2 (frag= arm: B = RuleRhs):", flush=True)
        results["k2_build"] = ptxas_report(build, "libtcec_matmul_p*.log")
        results["k2f_build"] = {
            lib: [dict(k, frag="RuleRhs" in k["kernel"]) for k in ks
                  if _kernel_name(k["kernel"]) == "k2_kernel"]
            for lib, ks in results["k2_build"].items()}
        for lib, ks in results["k2f_build"].items():
            for k in ks:
                if k["frag"]:
                    print(f"  frag= arm, {lib}: {k['registers']} registers, "
                          f"spill {k['spill_stores']}/{k['spill_loads']} B",
                          flush=True)
        rows = []
        _, results["k2f_launches"] = check_k2f(dev, rows)
        results["k2f"] = rows
        (out_dir / "chip_smoke_k2f.json").write_text(
            json.dumps(results, indent=1))
        print(f"k2f-only: passed in {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr)
        return 0
    if args.k3_only:
        rows = []
        check_k3(dev, rows)
        check_k3(dev, rows, K3_PROBES, ("bf16x6",))
        results["kernels"] = rows
        (out_dir / "chip_smoke_k3.json").write_text(
            json.dumps(results, indent=1))
        print(f"k3-only: passed in {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr)
        return 0
    rows = []
    heads = {"tcec_matmul": check_k2(dev, rows, l2_flush(dev))}
    from repro_torch.kernels import tcec_matmul as tm
    if "frag" in inspect.signature(tm.tcec_matmul_fused).parameters:
        heads["tcec_matmul_frag"], k2f_launches = check_k2f(dev, rows)
    elif src != SRC.resolve():
        # An earlier tree, driven through --src, without the frag= arm.
        k2f_launches = None
        print(f"K2f: {src} has no frag= arm; not run", flush=True)
    else:
        fail("tcec_matmul_fused takes no frag=")
    heads.update({"flash_attention": check_k3(dev, rows),
                  "paged_attention": check_k4(dev, rows),
                  **check_family(dev, rows),
                  "nonfinite_fixup": check_fixup(dev, rows)})
    results["kernels"] = rows
    if args.parity_only:
        (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
        print("parity-only: phase 1 passed", file=sys.stderr)
        return 0

    info = check_serve(dev, results)
    auto_launches = check_auto(dev, results)
    structured_launches, structured_heads = check_structured(dev, results)
    heads.update(structured_heads)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    # kernel -> (source, TPU kernel it replaces, launches on its path: the
    # serving run (phase 2) for K2-K4, the tcec_matmul_auto run (phase 3)
    # for K2b, K5 and K6, the structured ops' run (phase 4) for K7-K9).
    # One rule for every kernel: `launches` counts the host calls of its
    # wrapper that enqueued it, one per call; `enqueues` says what one such
    # call puts on the stream (K4: three kernels; K2: its product and, where
    # the plan splits k, a reduce kernel with the fix-up folded in).
    mm = "src/repro_torch/csrc/tcec_matmul.cu"
    staged = "src/repro_torch/csrc/tcec_staged.cu"
    fragments = "src/repro_torch/csrc/structured.cu"
    meta = {
        "tcec_matmul": ("src/repro_torch/csrc/tcec_matmul_k2.cu",
                        "src/repro/kernels/tcec_matmul.py:502",
                        info["launches"]),
        # K2's frag= arm; launches on its path, tcec.einsum with a menu rhs
        # (phase 1).
        "tcec_matmul_frag": ("src/repro_torch/csrc/tcec_matmul_k2.cu",
                             "src/repro/kernels/tcec_matmul.py:529",
                             k2f_launches),
        "tcec_matmul_pallas": (mm, "src/repro/kernels/tcec_matmul.py:73",
                               auto_launches),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:63",
                            info["launches"]),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/serving/paged_attention.py:65",
                            info["launches"]),
        "tcec_matmul_staged": (staged, "src/repro/kernels/tcec_matmul.py:106",
                               auto_launches),
        "tcec_matmul_staged_db": (staged,
                                  "src/repro/kernels/tcec_matmul.py:351",
                                  auto_launches),
        "householder_apply": (fragments,
                              "src/repro/kernels/structured.py:42",
                              structured_launches),
        "givens_apply": (fragments, "src/repro/kernels/structured.py:78",
                         structured_launches),
        "scan_cumsum": (fragments, "src/repro/kernels/structured.py:119",
                        structured_launches),
        # Not a pallas_call: the device half of the reference's non-finite
        # guard (its lax.cond); launches on the serving path (phase 2).
        "nonfinite_fixup": ("src/repro_torch/csrc/nonfinite_fixup.cu",
                            "src/repro/core/tcec.py:98",
                            info["launches"]),
    }
    enqueues = {
        "flash_attention": "with one split, one kernel; with splits, three: "
                           "the max pass, the split kernel, the merge",
        "tcec_matmul": "the product kernel; where k is split, a reduce "
                       "kernel with the fix-up folded in (also counted as "
                       "tcec_matmul_reduce); else, under a corrected "
                       "policy, the fix-up kernel (also counted as "
                       "nonfinite_fixup)",
        "paged_attention": "three kernels: scores, split softmax-V, merge",
        "nonfinite_fixup": "one fix-up kernel: the twin's guard, K2b/K5/K6's "
                           "or K2's with one split",
    }
    enqueues["tcec_matmul_frag"] = enqueues["tcec_matmul"]
    if k2f_launches is None:
        meta.pop("tcec_matmul_frag")
    ids = {"tcec_matmul": "K2", "tcec_matmul_frag": "K2f",
           "tcec_matmul_pallas": "K2b", "flash_attention": "K3",
           "paged_attention": "K4", "tcec_matmul_staged": "K5",
           "tcec_matmul_staged_db": "K6", "householder_apply": "K7",
           "givens_apply": "K8", "scan_cumsum": "K9",
           "nonfinite_fixup": "fix-up"}
    kernels = []
    for name, (source, replaces, launches) in meta.items():
        r = heads[name]
        if not launches[name]:
            fail(f"{name} was not launched on its path")
        kernels.append(dict(
            name=name, id=ids[name], route="cuda", source=source,
            replaces=replaces,
            launches=launches[name],
            enqueues=enqueues.get(name, "one kernel"),
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            # K7/K8: the fp32 torch.bmm, the call that computes their function
            library_ms=r.get("library_fp32_ms") or r["library_ms"]))
    print(f"chip_smoke: build and phases 1-4 in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
