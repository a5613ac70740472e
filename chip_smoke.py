#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Run from the repository root:

    python3 chip_smoke.py

It imports nothing of JAX or of the ``repro`` package.  It

  0. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     ``sm_90a``, one compiler per source, all started together);
  1. holds each kernel against its plain PyTorch version on the card at the
     shapes the qwen2-0.5b serving path gives it — the TCEC matmul (K2) also
     against an fp64 oracle — and times kernel, plain version and a PyTorch
     library call (a yardstick the port never calls) with CUDA events;
  2. serves qwen2-0.5b at full width (24 layers, random bf16 weights from a
     seed) through ``PagedServingEngine`` under ``bf16x6_pallas``, checks
     the launch counters and every request's output, then serves the same
     stream under ``bf16x6`` (the same split schedule as torch ops, no
     kernel), compares prefill logits between the two paths (on the bf16
     weights, and on the same model widened to fp32 weights, where the
     paths differ only in fp32 summation order), measures how far a mere
     change of summation order moves the twin's logits on the bf16 weights
     (the witness the bf16 limit is set from) and how both gaps grow with
     depth, and profiles three decode ticks of the kernel path.

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
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate.  Bounds below are derived from these, not measured.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

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


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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
    oracle_tol = {"bf16x1": 1e-2, "bf16x3": 1e-4, "bf16x6": 2e-6}
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
                if err_o >= oracle_tol[name]:
                    fail(f"K2 {name} m={m} k={k} n={n}: fp64-oracle error "
                         f"{err_o:.3e} >= {oracle_tol[name]:.0e}")
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
    if info_k["launches"] != expect:
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
             "paged_attention": check_k4(dev, rows)}
    results["kernels"] = rows
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    if args.parity_only:
        (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
        print("parity-only: phase 1 passed", file=sys.stderr)
        return 0

    info = check_serve(dev, results)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    meta = {
        "tcec_matmul": ("src/repro_torch/csrc/tcec_matmul.cu",
                        "src/repro/kernels/tcec_matmul.py:502"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:63"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/serving/paged_attention.py:65"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = heads[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=info["launches"][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
