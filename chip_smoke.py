#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Run from the repository root:

    python3 chip_smoke.py

It imports nothing of JAX or of the ``repro`` package.  It

  0. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     ``sm_90a``, one compiler per library and pass count, all started
     together);
  1. holds each kernel against its plain PyTorch version on the card at the
     shapes its path gives it — the TCEC matmuls (K2, K2b, K5, K6) also
     against an fp64 oracle, and K2b, K5 and K6 bitwise against each other
     over the whole tile menu — and times kernel, plain version and a
     PyTorch library call (a yardstick the port never calls) with CUDA
     events;
  2. serves qwen2-0.5b at full width (24 layers, random bf16 weights from a
     seed) through ``PagedServingEngine`` under ``bf16x6_pallas``, checks
     the launch counters and every request's output, then serves the same
     stream under ``bf16x6`` (the same split schedule as torch ops, no
     kernel), compares prefill logits between the two paths (on the bf16
     weights, and on the same model widened to fp32 weights, where the
     paths differ only in fp32 summation order), measures how far a mere
     change of summation order moves the twin's logits on the bf16 weights
     (the witness the bf16 limit is set from) and how both gaps grow with
     depth, and profiles three decode ticks of the kernel path;
  3. drives ``tcec_matmul_auto`` under ``REPRO_TUNE=measure`` (fresh plan
     cache under ``build/``) over the paper's batched-SGEMM sweep, a 4096^3
     product and qwen2-0.5b's w_gate at prefill: the chosen (variant, tile),
     every variant's best time, cuBLAS SGEMM's, the bounds, a cache hit on
     a second plan, and each kernel's shared memory and blocks per SM
     against the port's footprint model;
  4. drives the structured ops ``repro_torch.kernels.ops.householder``,
     ``givens`` and ``cumsum`` (K7-K9: H, G and the triangular ones made in
     registers) at the paper's benchmark shapes and at one shape per op
     that fills the card, checks them against their plain versions and the
     JAX tests' properties, holds each kernel against its plain version at
     the JAX tests' shapes and a ragged one, checks the bf16-overflow
     ±inf/NaN pattern, and times kernel, plain version and the staged
     library flow (``torch.bmm`` of the materialized matrix; for the scan
     ``torch.cumsum``).

Any failed check exits non-zero.  It prints the card's name and power limit,
a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Full tables go to
``build/chip_smoke.json``.  ``--parity-only`` stops after phase 1 and prints
no result line.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
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


def time_ms(fn, reps: int = 20, queued: bool = True) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events around
    each call).  With ``queued`` the calls are enqueued behind a sleeping
    kernel so host overhead does not show up as device time; ``fn`` must
    then not synchronise."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if queued:
        torch.cuda._sleep(200_000_000)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in ev)
    return ts[len(ts) // 2]


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

def check_k2(dev, rows):
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import tcec_matmul as tm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # (k, n) of the layer shapes, with the lhs dtype, bias and activation
    # the qwen2 path gives them under bf16x6_pallas.
    layers = {(896, 896): ("wo", torch.float32, False, None),
              (896, 128): ("wk/wv", torch.bfloat16, True, None),
              (896, 4864): ("w_gate", torch.bfloat16, False, "silu"),
              (4864, 896): ("w_down", torch.bfloat16, False, None)}
    headline = None
    for m in (4, 256):
        for (k, n), (layer, a_dt, has_bias, act) in layers.items():
            a32 = torch.randn(m, k, generator=gen, device=dev)
            b32 = torch.randn(k, n, generator=gen, device=dev)
            w = (torch.randn(k, n, generator=gen, device=dev)
                 / k ** 0.5).to(torch.bfloat16)
            x = torch.randn(m, k, generator=gen, device=dev).to(a_dt)
            bias = (torch.randn(n, generator=gen, device=dev)
                    .to(torch.bfloat16) if has_bias else None)
            oracle = (a32.double() @ b32.double())
            for name in ("bf16x1", "bf16x3", "bf16x6"):
                pol = get_policy(name)
                # fp32 operands: accuracy against the fp64 oracle.
                got = tm.tcec_matmul_fused(a32, b32, pol)
                err_o = max_rel(got, oracle)
                if err_o >= ORACLE_TOL[name]:
                    fail(f"K2 {name} m={m} k={k} n={n}: fp64-oracle error "
                         f"{err_o:.3e} >= {ORACLE_TOL[name]:.0e}")
                err_p32 = max_rel(got, tm.tcec_matmul_plain(a32, b32, pol))
                # The path's dtypes and epilogue: against the plain version.
                kw = dict(bias=bias, activation=act)
                got = tm.tcec_matmul_fused(x, w, pol, **kw)
                plain = tm.tcec_matmul_plain(x, w, pol, **kw)
                err_p = max(max_rel(got, plain), err_p32)
                if err_p >= 1e-5:
                    fail(f"K2 {name} m={m} k={k} n={n}: kernel vs plain "
                         f"{err_p:.3e} >= 1e-5")
                _, _, launch = tm.launcher(x, w, pol, bias=bias,
                                           activation=act)
                ms = time_ms(launch)
                plain_ms = time_ms(
                    lambda: tm.tcec_matmul_plain(x, w, pol, **kw),
                    queued=False)
                a_lib, b_lib = x.float(), w.float()
                lib_ms = time_ms(lambda: torch.matmul(a_lib, b_lib))
                n_bytes = (x.numel() * x.element_size()
                           + w.numel() * w.element_size() + m * n * 4
                           + (n * 2 if has_bias else 0))
                b_ms, b_by = bound_ms(n_bytes, 2.0 * m * n * k * pol.passes)
                row = dict(kernel="tcec_matmul", layer=layer, m=m, k=k, n=n,
                           policy=name, a_dtype=str(a_dt).split(".")[-1],
                           bias=has_bias, activation=act,
                           oracle_err=err_o, max_abs_err=float(
                               (got.double() - plain.double()).abs().max()),
                           rel_err_vs_plain=err_p, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                print(f"K2 {layer:7s} m={m:3d} k={k:4d} n={n:4d} {name}: "
                      f"oracle {err_o:.2e} plain {err_p:.2e} | "
                      f"{ms:.4f} ms (plain {plain_ms:.4f}, fp32 matmul "
                      f"{lib_ms:.4f}, bound {b_ms:.4f} {b_by})", flush=True)
                if (m, k, n, name) == (4, 896, 4864, "bf16x6"):
                    headline = row
    return headline


def check_k3(dev, rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    b, h, kvh, s, d = 1, 14, 2, 256, 64
    normal = [torch.randn(b, n, s, d, generator=gen, device=dev)
              for n in (h, kvh, kvh)]
    grid = [on_grid(x, gen) for x in normal]
    headline = None
    for name in ("bf16x1", "bf16x3", "bf16x6"):
        pol = get_policy(name)
        q, k, v = grid if name == "bf16x1" else normal
        got = fa.flash_attention(q, k, v, causal=True, policy=pol)
        plain = fa.flash_attention_plain(q, k, v, pol, causal=True)
        err = max_rel(got, plain)
        if err >= 1e-5:
            fail(f"K3 {name}: kernel vs plain {err:.3e} >= 1e-5")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                policy=pol))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, pol, causal=True))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k.repeat_interleave(h // kvh, 1),
            v.repeat_interleave(h // kvh, 1), is_causal=True))
        pairs = s * (s + 1) // 2                       # causal (row, col)
        n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 4
        b_ms, b_by = bound_ms(n_bytes, 2.0 * pairs * 2 * d * h * b
                              * pol.passes)
        row = dict(kernel="flash_attention", b=b, h=h, kvh=kvh, sq=s, d=d,
                   causal=True, policy=name, rel_err_vs_plain=err,
                   max_abs_err=float((got - plain).abs().max()), ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        print(f"K3 (1,14,256,64) kvh2 causal {name}: plain {err:.2e} | "
              f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, bound "
              f"{b_ms:.4f} {b_by})", flush=True)
        if name == "bf16x6":
            headline = row
    return headline


def check_k4(dev, rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.policy import get_policy
    from repro_torch.serving import paged_attention as pa
    from repro_torch.serving.paged_cache import gather_pages
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    h, kvh, d = 14, 2, 64
    lens = [0, 37, 190, 288]                     # mixed, including empty
    b = len(lens)
    npages = -(-max(lens) // PAGE)
    n_phys = 1 + b * npages
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev) + 1
    block_table = perm[:b * npages].reshape(b, npages).to(torch.int32)
    k_pages = torch.randn(n_phys, PAGE, kvh, d, generator=gen,
                          device=dev).to(torch.bfloat16)
    v_pages = torch.randn(n_phys, PAGE, kvh, d, generator=gen,
                          device=dev).to(torch.bfloat16)
    q = torch.randn(b, h, d, generator=gen, device=dev)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    normal = (q, k_pages, v_pages)
    grid = [on_grid(x, gen) for x in normal]
    headline = None
    for name in ("bf16x1", "bf16x3", "bf16x6"):
        pol = get_policy(name)
        q, k_pages, v_pages = grid if name == "bf16x1" else normal
        kv = gather_pages(k_pages, block_table).float()
        vv = gather_pages(v_pages, block_table).float()
        kk = kv.permute(0, 2, 1, 3).repeat_interleave(h // kvh, 1)
        vk = vv.permute(0, 2, 1, 3).repeat_interleave(h // kvh, 1)
        mask = (torch.arange(kv.shape[1], device=dev)[None]
                < seq_lens[:, None])[:, None, None]
        run = (lambda: pa.paged_decode_attention_kernel(
            q, k_pages, v_pages, block_table, seq_lens, policy=pol))
        got = run()
        plain = pa.paged_decode_attention_plain(
            q, k_pages, v_pages, block_table, seq_lens,
            scale=1.0 / d ** 0.5, policy=pol)
        if not bool((got[0] == 0).all()):
            fail("K4: a zero-length request did not give zeros")
        err = max_rel(got, plain)
        if err >= 1e-5:
            fail(f"K4 {name}: kernel vs plain {err:.3e} >= 1e-5")
        ms = time_ms(run)
        plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
            q, k_pages, v_pages, block_table, seq_lens,
            scale=1.0 / d ** 0.5, policy=pol), queued=False)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kk, vk, attn_mask=mask))
        live = sum(lens)
        n_bytes = (live * kvh * d * 2 * 2 + q.numel() * 4 * 2
                   + block_table.numel() * 4 + b * 4)
        b_ms, b_by = bound_ms(n_bytes, 2.0 * live * h * 2 * d * pol.passes)
        row = dict(kernel="paged_attention", b=b, h=h, kvh=kvh, d=d,
                   page=PAGE, seq_lens=lens, policy=name,
                   rel_err_vs_plain=err,
                   max_abs_err=float((got - plain).abs().max()), ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        print(f"K4 4 slots h14 kvh2 page16 lens {lens} {name}: plain "
              f"{err:.2e} | {ms:.4f} ms (plain {plain_ms:.4f}, sdpa over "
              f"gathered {lib_ms:.4f}, bound {b_ms:.4f} {b_by})", flush=True)
        if name == "bf16x6":
            headline = row
    return headline


#: Shapes of the tcec_matmul_auto path (phase 3) the K2b/K5/K6 checks run
#: at: name -> (lhs, rhs).  "oracle" is k = 4864, m = 256 (the fp64-oracle
#: bounds' shape); "w_gate" qwen2-0.5b's gate layer at prefill; "batched"
#: the paper's batched regime at s = 128; "ragged" a broadcast rhs with
#: dims that no tile divides.
FAMILY_SHAPES = {
    "oracle": ((256, 4864), (4864, 896)),
    "w_gate": ((256, 896), (896, 4864)),
    "batched": ((256, 128, 128), (256, 128, 128)),
    "ragged": ((3, 40, 72), (72, 136)),
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
    variants = {"tcec_matmul_pallas": tm.pallas_launcher,
                "tcec_matmul_staged": functools.partial(
                    tm.staged_launcher, double_buffer=False),
                "tcec_matmul_staged_db": functools.partial(
                    tm.staged_launcher, double_buffer=True)}
    calls = {"tcec_matmul_pallas": tm.tcec_matmul_pallas,
             "tcec_matmul_staged": tm.tcec_matmul_staged,
             "tcec_matmul_staged_db": tm.tcec_matmul_staged_db}
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
                else list(variants)
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
                out, *_, launch = variants[kname](a, b, pol)
                ms = time_ms(launch)
                b_ms, b_by = family_bound(a, b, out, pol)
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
                    else list(variants)
                for kname in kernels:
                    got = calls[kname](a_bad, b, pol)
                    bad = ~torch.isfinite(ref)
                    if not (torch.equal(torch.isnan(got), torch.isnan(ref))
                            and torch.equal(got[bad & ~torch.isnan(ref)],
                                            ref[bad & ~torch.isnan(ref)])
                            and bool(torch.isfinite(got[~bad]).all())):
                        fail(f"{kname} {name}: non-finite pattern differs "
                             f"from the fp32 product's")
            print("K2b/K5/K6: non-finite inputs give the fp32 product's "
                  "±inf/NaN pattern under every policy", flush=True)
    return heads


# ---------------------------------------------------------------------------
# Phase 2: serve qwen2-0.5b at full width
# ---------------------------------------------------------------------------

def serve(dev, cfg, params, prompts, policy):
    """One engine run over ``prompts``; returns (outputs, info)."""
    import torch
    from repro_torch.core.context import policy_scope
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, page_size=PAGE,
                             max_concurrency=SLOTS,
                             max_seq_len=max(map(len, prompts)) + N_NEW + 1,
                             device=dev)
    for p in prompts:
        eng.submit(p, N_NEW)
    tick_ms, decode_ms = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with policy_scope(policy):
        while not eng.scheduler.done:
            t = time.perf_counter()
            plan = eng.step()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            tick_ms.append(dt)
            if plan.decode and not plan.prefill:
                decode_ms.append(dt)
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
                logits_finite=eng.all_logits_finite)
    return out, info


def profile_decode(dev, cfg, params, prompts, ticks: int = 3):
    """Device time by kernel over ``ticks`` decode ticks of the kernel path
    (torch.profiler), and the device's busy share of the wall time."""
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
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(f"decode tick profile ({ticks} ticks): wall {wall_ms / ticks:.2f} "
          f"ms/tick, device busy {busy:.2f} ms/tick "
          f"({100 * busy / (wall_ms / ticks):.1f}%)", flush=True)
    for name, ms in top:
        print(f"  {ms:8.3f} ms/tick  {name[:100]}")
    return dict(wall_ms_per_tick=wall_ms / ticks, busy_ms_per_tick=busy,
                top_kernels_ms_per_tick=top)


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
    from repro_torch.configs import get_config
    from repro_torch.core.context import policy_scope
    from repro_torch.models import init_params
    from repro_torch.models.model import _logits
    import numpy as np
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, dev)
    rs = np.random.default_rng(SEED)
    lens = [64, 256] + [int(n) for n in rs.integers(64, 257, 2)]
    prompts = [[int(t) for t in rs.integers(0, cfg.vocab, n)] for n in lens]
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
    if launched != expect:
        fail(f"launch counts {info_k['launches']} != expected {expect}")
    if sorted(out_k) != list(range(len(prompts))) or any(
            len(v) != N_NEW for v in out_k.values()):
        fail(f"bf16x6_pallas: outputs {[len(v) for v in out_k.values()]}")
    if not info_k["logits_finite"]:
        fail("bf16x6_pallas: non-finite logits")
    print(f"serve bf16x6_pallas: {info_k['tokens']} tokens in "
          f"{info_k['seconds']:.3f} s = {info_k['tok_per_s']:.1f} tok/s, "
          f"decode tick median {info_k['decode_tick_ms_median']:.2f} ms, "
          f"launches {info_k['launches']} (expected)", flush=True)

    out_t, info_t = serve(dev, cfg, params, prompts, "bf16x6")
    if any(info_t["launches"].values()):
        fail(f"bf16x6 twin launched kernels: {info_t['launches']}")
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
    results["serve"] = dict(kernel_run=info_k, twin_run=info_t,
                            prefill_logit_err=errs, lm_head_ms=head_ms,
                            prompt_lens=lens, greedy_equal=same,
                            decode_profile=profile)
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
                smem, _build.tile_threads(*tile[:2]), got["regs"])
            row = dict(variant=variant, tile=list(tile), **got,
                       model_smem_bytes=smem, model_blocks_per_sm=blocks)
            table.append(row)
            print(f"  {variant:9s} {str(tile):15s} {got['smem_bytes']:7d} B "
                  f"(model {smem:7d}), {got['threads']:3d} threads, "
                  f"{got['regs']:3d} regs, {got['blocks_per_sm']:2d} "
                  f"blocks/SM (model {blocks:2d})", flush=True)
            if (got["smem_bytes"], got["blocks_per_sm"], got["threads"]) \
                    != (smem, blocks, _build.tile_threads(*tile[:2])):
                fail(f"footprint of {variant} {tile}: card {got}, model "
                     f"{smem} B, {blocks} blocks/SM")
    return table


def kernel_only_us(a, b, pol):
    """Each variant's best time over the tile menu with the kernel alone
    enqueued (the host split of K5/K6 and the guard left out): the paper's
    comparison of data flows.  Run after the path's launches are read."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcec_matmul as tm
    from repro_torch.tune import matmul_variants
    best = {}
    for variant in matmul_variants(pol):
        for tile in _build.TILES:
            if variant == "fused":
                _, _, launch = tm.pallas_launcher(a, b, pol, tile)
            else:
                _, launch = tm.staged_launcher(
                    a, b, pol, tile, double_buffer=variant == "staged_db")
            us = time_ms(launch, reps=10) * 1e3
            if us < best.get(variant, (float("inf"),))[0]:
                best[variant] = (us, list(tile))
    return best


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
            kernel = kernel_only_us(a, b, pol)
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
                       sgemm_ms=sgemm_ms, sgemm_tflops=flops / sgemm_ms / 1e9,
                       bound_ms=b_ms, bound_by=b_by,
                       bound_tflops=flops / b_ms / 1e9,
                       simt_peak_tflops=FP32_FLOPS / 1e12)
            rows.append(row)
            per = ", ".join(f"{v} {t:.1f} us {flops / t / 1e6:.2f} TF/s"
                            for v, (t, _) in sorted(best.items()))
            kper = ", ".join(f"{v} {t:.1f} us {tuple(bl)} {flops / t / 1e6:.2f}"
                             f" TF/s" for v, (t, bl) in sorted(kernel.items()))
            print(f"auto {name:7s}: chose {plan.variant} {plan.block} | "
                  f"call: {per} | kernel alone: {kper} | cuBLAS SGEMM "
                  f"{sgemm_ms * 1e3:.1f} us {row['sgemm_tflops']:.2f} TF/s | "
                  f"bound {b_ms * 1e3:.2f} us {row['bound_tflops']:.1f} TF/s "
                  f"({b_by}), fp32 SIMT peak 67 TF/s | oracle {err:.2e} | "
                  f"cache hit", flush=True)
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
             (24, 96, 48)]
#: The path's shapes: the paper's benchmarks as the JAX package defines them
#: (benchmarks/householder.py, benchmarks/givens.py) and one shape per op
#: that fills the card ("full", ≈ 270 MB of fp32 in and out).
HH_PATH = {"bench_m16": (512, 16, 64), "bench_m32": (512, 32, 64),
           "full": (16384, 32, 64)}
GV_PATH = {"bench": (1024, 32, 32, 3, 17), "full": (32768, 32, 32, 3, 17)}
CS_PATH = {"full": (4096, 8192, 256)}
BF16_OVERFLOW = 3.4e38   # finite in fp32, rounds to inf in bf16


def close(got, ref, tol: float) -> float:
    """max |got - ref| after checking |got - ref| <= tol + tol * |ref|
    elementwise (numpy's allclose at rtol = atol = tol); inf if not."""
    err = (got.double() - ref.double()).abs()
    if not bool((err <= tol + tol * ref.double().abs()).all()):
        return float("inf")
    return float(err.max()) if err.numel() else 0.0


def same_nonfinite(got, ref) -> bool:
    """Same NaN positions, same ±inf values, finite parts within 1e-5."""
    import torch
    inf, fin = torch.isinf(ref), torch.isfinite(ref)
    return (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(got[inf], ref[inf])
            and close(got[fin], ref[fin], 1e-5) < float("inf"))


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
    G in bf16 through ``torch.bmm``) or ``torch.cumsum``, beside the bound.
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
            n_bytes = 4 * (v.numel() + 2 * a.numel())
            flops = 2.0 * b * m * m * k
        elif kname == "givens_apply":
            th, a = gv[s]
            b, m, k, gi, gj = shape
            _, launch = st.givens_launcher(th, a, gi, gj)
            plain = functools.partial(st.givens_plain, th, a, gi, gj)
            make = (lambda: st.givens_matrices(th, m, gi, gj).to(bf))
            n_bytes = 4 * (th.numel() + 2 * a.numel())
            flops = 2.0 * b * m * m * k
        else:
            x = cs[s]
            r, n, bn = shape
            _, launch = st.scan_launcher(x, bn)
            plain = functools.partial(st.scan_cumsum_plain, x, bn)
            make = None
            n_bytes = 4 * 2 * x.numel()
            flops = 2.0 * r * n * bn
        ms = time_ms(launch)
        plain_ms = time_ms(plain, queued=False)
        if make is None:
            lib = "torch.cumsum fp32"
            lib_ms = time_ms(lambda: torch.cumsum(x, dim=1))
            make_ms = None
        else:
            lib = "torch.bmm bf16 (materialized)"
            mat, a_bf = make(), a.to(bf)
            lib_ms = time_ms(lambda: torch.bmm(mat, a_bf))
            make_ms = time_ms(make)
        b_ms, b_by = bound_ms(n_bytes, flops)
        row.update(kernel=kname, dims=list(shape), ms=ms, plain_ms=plain_ms,
                   library=lib, library_ms=lib_ms,
                   materialize_ms=make_ms, bound_ms=b_ms, bound_by=b_by,
                   launches=counts[kname])
        print(f"{kname:17s} {s:9s} {str(shape):24s}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f}, {lib} {lib_ms:.4f}"
              + ("" if make_ms is None else f" + materialize {make_ms:.4f}")
              + f", bound {b_ms:.4f} {b_by}"
              + ("" if s == "full" else "; launch cost sets this shape's "
                 "time") + f") | {row['check']} {row['check_value']:.3e}",
              flush=True)
        if s == "full":
            heads[kname] = row
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)
    results["structured"] = dict(rows=rows, launches=got_counts)
    return counts, heads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parity-only", action="store_true",
                    help="build and run phase 1 only; no result line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
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
    t0 = time.perf_counter()
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

    results = {"card": card, "torch": torch.__version__,
               "build": build_info}
    rows = []
    heads = {"tcec_matmul": check_k2(dev, rows),
             "flash_attention": check_k3(dev, rows),
             "paged_attention": check_k4(dev, rows),
             **check_family(dev, rows)}
    results["kernels"] = rows
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
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
    # for K2b, K5 and K6, the structured ops' run (phase 4) for K7-K9)
    mm = "src/repro_torch/csrc/tcec_matmul.cu"
    staged = "src/repro_torch/csrc/tcec_staged.cu"
    fragments = "src/repro_torch/csrc/structured.cu"
    meta = {
        "tcec_matmul": (mm, "src/repro/kernels/tcec_matmul.py:502",
                        info["launches"]),
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
    }
    kernels = []
    for name, (source, replaces, launches) in meta.items():
        r = heads[name]
        if not launches[name]:
            fail(f"{name} was not launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
