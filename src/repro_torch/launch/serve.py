"""Paged serving launcher of the port (counterpart of ``repro.launch.serve``,
paged mode).

    PYTHONPATH=src python -m repro_torch.launch.serve --paged \\
        --arch qwen2-0.5b --policy bf16x6_pallas

``--policy bf16x6_pallas`` runs every dense layer on the TCEC matmul kernel,
prefill attention on the flash kernel and decode attention on the paged
kernel; ``--policy bf16x6`` runs the same split schedule as torch ops.
``--device cpu`` runs the plain versions on the CPU (use ``--reduced``).
Parameters are random, drawn from ``--seed``.  The dense (non-paged) serve
path is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import add_policy_args, policy_scope_from_args
from repro_torch.models import init_params
from repro_torch.models.base import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_paged(cfg, params, prompts, gen_steps, *, page_size=16,
                   max_concurrency=4, device="cuda", stats=None):
    """Continuous-batching generation over paged caches.

    ``prompts`` is a list of token lists (mixed lengths welcome).  Pass a
    dict as ``stats`` to receive the engine's counters and per-phase wall
    times.  Returns ({rid: tokens}, tokens/sec)."""
    from repro_torch.serving import PagedServingEngine
    max_seq = max(len(p) for p in prompts) + gen_steps + 1
    eng = PagedServingEngine(cfg, params, page_size=page_size,
                             max_concurrency=max_concurrency,
                             max_seq_len=max_seq, device=device)
    for pr in prompts:
        eng.submit(pr, gen_steps)
    _sync(eng.device)
    t0 = time.perf_counter()
    out = eng.run()
    _sync(eng.device)
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.update(eng.stats)
        stats["seconds"] = dt
    n_tok = sum(len(v) for v in out.values())
    return out, n_tok / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV cache + continuous-"
                         "batching engine (the only mode ported so far)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-concurrency", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    add_policy_args(ap)
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("only --paged serving is ported to repro_torch so far")

    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    # mixed-length stream: each prompt trimmed to a different length
    rs = np.random.default_rng(args.seed)
    lens = rs.integers(max(1, args.prompt_len // 2), args.prompt_len + 1,
                       args.batch)
    prompts = [list(rs.integers(0, cfg.vocab, int(n))) for n in lens]
    stats = {}
    with policy_scope_from_args(args):
        out, tps = generate_paged(cfg, params, prompts, args.gen,
                                  page_size=args.page_size,
                                  max_concurrency=args.max_concurrency,
                                  device=device, stats=stats)
    print(f"generated {sum(len(v) for v in out.values())} tokens over "
          f"{len(out)} requests at {tps:.1f} tok/s (paged, "
          f"page={args.page_size}, slots={args.max_concurrency}, "
          f"device={device}, {stats['prefills']} prefills, "
          f"{stats['decode_ticks']} decode ticks)")
    print("sample:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
