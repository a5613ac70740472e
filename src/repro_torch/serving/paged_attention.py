"""Paged decode attention — block-table reads inside the kernel, QK^T/PV on
the shared TCEC split schedule (counterpart of
``repro.serving.paged_attention``, GQA with unquantized pages).

  * ``paged_decode_attention_kernel`` — K4: the CUDA kernels of
    ``csrc/paged_attention.cu`` on CUDA tensors, its plain version
    ``paged_decode_attention_plain`` on CPU tensors;
  * ``paged_decode_attention_xla`` — the gather twin: materialize the
    block table's pages and run the contiguous ``decode_attention``;
  * ``paged_decode_attention`` — the dispatch: a policy with
    ``kernel == "pallas"`` on the tensor-core backend takes the kernel,
    anything else the twin.

K4 is flash-decoding: ``k4_plan`` splits the block table's positions, in
whole 16-position chunks, across blocks; a scores pass writes every chunk's
scaled, masked scores and row max; each split runs the online softmax over
its chunks starting from the max of the chunks before it (so every P is the
reference's, rounded at the same places); a merge combines the splits'
(m, l, acc) in split order.  ``k4_passes`` runs only the passes whose words
can be nonzero.  The plain version follows the same plan, chunks, max rule
and merge order, and reads nothing on the host.

Not ported yet: MLA (``paged_mla_decode_attention``, the kernel's second
score pair), int8 pages with per-page scales, ``paged_prefill_attention``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.tcec_core import dot_params, kernel_passes, policy_dot
from repro_torch.kernels.tcec_matmul import k2_passes, plan_sms
from .paged_cache import gather_pages

__all__ = ["paged_decode_attention", "paged_decode_attention_kernel",
           "paged_decode_attention_plain", "paged_decode_attention_xla",
           "k4_plan", "k4_passes", "K4Plan", "LAUNCHES", "CHUNK"]

LAUNCHES = _build.counter("paged_attention")
NEG_INF = -1e30
#: Positions per online-softmax step, in the kernels and the plain version
#: (one page, and so the reference's blocking, when page_size == 16).
CHUNK = 16
#: The largest head dims (d and dv) the kernels take.
MAX_HEAD_DIM = 256
#: K4 aims at this many blocks of its split kernel per SM.
K4_BLOCKS_PER_SM = 2
#: Every split but the last holds at least this many chunks (32 positions:
#: two pages of 16), so each of a block's two warps has a chunk.
K4_MIN_CHUNKS = 2
#: Columns of dv per block of the split kernel (one m16 tile).
K4_DV_TILE = 16


@dataclasses.dataclass(frozen=True)
class K4Plan:
    """How K4 runs a call: the block table's positions in ``chunks``
    16-position chunks, ``splits`` ranges of ``per`` chunks each (split s
    covers chunks [s * per, min(chunks, (s + 1) * per))); ``blocks`` is the
    split kernel's grid (per (slot, kv head, group of 8 query heads, split,
    16 columns of dv))."""
    chunks: int
    splits: int
    per: int
    blocks: int


def k4_plan(batch: int, kvh: int, rep: int, npages: int, page: int,
            sms: int = 132, *, dv: int) -> K4Plan:
    """K4's plan for ``batch`` slots of ``kvh`` kv heads with ``rep`` query
    heads each over a block table of ``npages`` pages of ``page``
    positions, value head dim ``dv``, on a card of ``sms`` SMs: as many
    splits as bring the split kernel to ``K4_BLOCKS_PER_SM * sms`` blocks,
    each of whole chunks and, but for the last, of at least
    ``K4_MIN_CHUNKS``.  A plain function of its arguments: it never reads
    the sequence lengths (that would be a host sync)."""
    chunks = -(-npages * page // CHUNK)
    units = batch * kvh * -(-rep // 8) * -(-dv // K4_DV_TILE)
    want = -(-K4_BLOCKS_PER_SM * sms // max(1, units))
    splits = max(1, min(want, chunks // K4_MIN_CHUNKS))
    per = max(1, chunks // splits)          # rounded down: at least `splits`
    splits = max(1, -(-chunks // per))
    return K4Plan(chunks, splits, per, units * splits)


def k4_passes(policy: TcecPolicy, q_dtype: torch.dtype,
              page_dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The schedule passes (q word, page word) K4 runs for q·K^T with these
    dtypes, in schedule order — ``k2_passes``'s rule: a bf16 operand is its
    own word 0, so a pass reading another of its words is skipped.  P·V
    runs ``k4_passes(policy, torch.float32, page_dtype)`` (P is fp32)."""
    return k2_passes(policy, q_dtype, page_dtype)


def _corrected(pol: TcecPolicy) -> bool:
    return pol.error_correction or pol.backend == "vpu"


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 seq_lens: torch.Tensor, *, scale: float,
                                 policy: TcecPolicy) -> torch.Tensor:
    """The kernels' arithmetic in torch ops, on ``k4_plan``'s splits (for
    the card ``q`` lies on; for a CPU tensor, an H100's 132 SMs): the masked, scaled scores of every chunk and
    their row max; per split, the online softmax over its chunks from the
    max of the chunks before it (P and P·V through ``policy_dot``); the
    splits merged in order.  q (b, h, d) -> (b, h, dv) fp32."""
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    rep, dv = h // kvh, v_pages.shape[-1]
    plan = k4_plan(b, kvh, rep, block_table.shape[1], page,
                   plan_sms(q.device), dv=dv)
    kw = dot_params(policy)
    kv = gather_pages(k_pages, block_table).float().transpose(1, 2)
    vv = gather_pages(v_pages, block_table).float().transpose(1, 2)
    qh = q.float().reshape(b, kvh, rep, d)
    lens = seq_lens.to(torch.int64).clamp(0, kv.shape[2])[:, None, None,
                                                           None]
    dev = q.device
    neg = torch.full((b, kvh, rep, 1), NEG_INF, device=dev)
    scores, cmax = [], []
    for c in range(plan.chunks):
        kb = kv[:, :, c * CHUNK:(c + 1) * CHUNK]
        s = policy_dot(qh, kb, "bgrd,bgsd->bgrs", **kw) * scale
        cols = c * CHUNK + torch.arange(kb.shape[2], device=dev)
        s = torch.where(cols < lens, s, NEG_INF)
        scores.append(s)
        cmax.append(s.amax(-1, keepdim=True))
    parts = []
    for sp in range(plan.splits):
        c0 = sp * plan.per
        m = neg
        for c in range(c0):
            m = torch.maximum(m, cmax[c])
        l = torch.zeros_like(neg)
        acc = torch.zeros((b, kvh, rep, dv), device=dev)
        for c in range(c0, min(plan.chunks, c0 + plan.per)):
            vb = vv[:, :, c * CHUNK:(c + 1) * CHUNK]
            m_new = torch.maximum(m, cmax[c])
            alpha = torch.exp(m - m_new)
            p = torch.where(m_new > 0.5 * NEG_INF,
                            torch.exp(scores[c] - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + policy_dot(p, vb, "bgrs,bgsd->bgrd", **kw)
            m = m_new
        # A split wholly past a request's length is empty (m = NEG_INF).
        parts.append((torch.where(c0 * CHUNK < lens, m, NEG_INF), l, acc))
    big_m = neg
    for m, _, _ in parts:
        big_m = torch.maximum(big_m, m)
    l = torch.zeros_like(neg)
    acc = torch.zeros((b, kvh, rep, dv), device=dev)
    for m, l_s, acc_s in parts:
        w = torch.where(m > 0.5 * NEG_INF, torch.exp(m - big_m), 0.0)
        l = l + l_s * w
        acc = acc + acc_s * w
    out = torch.where(l > 0.0, acc / torch.where(l > 0.0, l, 1.0), 0.0)
    return out.reshape(b, h, dv)


def _workspace_floats(rows: int, plan: K4Plan, dv: int) -> int:
    """Floats of the kernels' workspace (``csrc/paged_attention.cu``'s
    ``workspace_floats``): scores, chunk maxima, and each split's m, l and
    acc, each part on a 16-byte boundary."""
    def round4(n):
        return -(-n // 4) * 4
    return (round4(rows * plan.chunks * CHUNK) + round4(rows * plan.chunks)
            + 2 * round4(rows * plan.splits) + rows * plan.splits * dv)


def _entry(passes: int):
    lib = _build.load("paged_attention", passes)
    fn = lib.repro_paged_decode_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci,
                       ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, ci,
                       vp]
        fn.restype = ci
    return lib, fn


def launcher(q, k_pages, v_pages, block_table, seq_lens, scale, pol):
    """Validate a CUDA call, plan it (``k4_plan``) and allocate its output
    and workspace; returns ``(out, launch)`` where ``launch()`` enqueues
    the three kernels in one host call (counted once, no host sync).
    ``launch.plan`` is the plan."""
    what = "paged_decode_attention"
    passes = kernel_passes(pol, what)
    b, h, d = q.shape
    _, page, kvh, dk = k_pages.shape
    dv = v_pages.shape[-1]
    if dk != d or tuple(v_pages.shape[:3]) != tuple(k_pages.shape[:3]):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k pages "
                         f"{tuple(k_pages.shape)}, v pages "
                         f"{tuple(v_pages.shape)} disagree")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: head dims d={d}, dv={dv} — the kernels take d, dv <= "
            f"{MAX_HEAD_DIM}")
    if k_pages.dtype != v_pages.dtype or \
            k_pages.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"{what}: pages must both be fp32 or bf16 (int8 pages are not "
            f"ported yet), got {k_pages.dtype}/{v_pages.dtype}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if x.device != q.device:
            raise ValueError(f"{what}: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError(f"{what}: block_table and seq_lens must be int32")
    dev = q.device
    npages = block_table.shape[1]
    rep = h // kvh
    plan = k4_plan(b, kvh, rep, npages, page, plan_sms(dev), dv=dv)
    qf = q.float().contiguous()
    out = torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    n_ws = _workspace_floats(b * h, plan, dv)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)

    def launch():
        if out.numel() == 0:
            return
        if npages == 0:                 # no position: every length is 0
            out.zero_()
            return
        lib, fn = _entry(passes)
        rc = fn(qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                ws.data_ptr(), n_ws, b, kvh, rep, d, dv, page, npages,
                plan.splits, plan.per, float(scale),
                int(k_pages.dtype == torch.bfloat16),
                int(q.dtype == torch.bfloat16), passes,
                _build.stream_ptr(dev))
        _build.check(lib, rc, what)
        LAUNCHES.hit()

    launch.plan = plan
    return out, launch


def paged_decode_attention_kernel(q, k_pages, v_pages, block_table, seq_lens,
                                  *, scale: Optional[float] = None,
                                  policy: TcecPolicy | str | None = None
                                  ) -> torch.Tensor:
    """Fused paged decode attention (one query token per request).

    q ``(b, h, d)``; ``k_pages (P, page, kvh, d)``, ``v_pages (P, page,
    kvh, dv)``; ``block_table (b, npages)`` int32; ``seq_lens (b,)`` int32
    — request ``i`` attends to its first ``seq_lens[i]`` positions; a zero
    length emits zeros.  Returns ``(b, h, dv)`` fp32 for corrected/vpu
    policies, ``q.dtype`` for the plain bf16 policy.  On a CUDA tensor d
    and dv above 256 raise ``NotImplementedError``.
    """
    pol = resolve_policy(policy, "attn")
    b, h, d = q.shape
    if h % k_pages.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k_pages.shape[2]}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.is_cuda:
        out, launch = launcher(q, k_pages, v_pages, block_table, seq_lens,
                               scale, pol)
        launch()
    else:
        out = paged_decode_attention_plain(q, k_pages, v_pages, block_table,
                                           seq_lens, scale=scale, policy=pol)
    return out if _corrected(pol) else out.to(q.dtype)


def paged_decode_attention_xla(q, k_pages, v_pages, block_table, seq_lens, *,
                               policy: TcecPolicy | str | None = None
                               ) -> torch.Tensor:
    """Gather twin: the block table's pages as a contiguous cache, then the
    contiguous ``decode_attention`` — the dense decode path's arithmetic."""
    from repro_torch.models.attention import decode_attention
    pol = resolve_policy(policy, "attn")
    kv = gather_pages(k_pages, block_table)
    vv = gather_pages(v_pages, block_table)
    o = decode_attention(q[:, None], kv, vv, seq_lens.to(torch.int32) - 1,
                         policy=pol)
    return o[:, 0]


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                           policy: TcecPolicy | str | None = None
                           ) -> torch.Tensor:
    """Policy-dispatching paged decode attention (GQA): ``kernel ==
    "pallas"`` on the tensor-core backend takes K4, anything else the
    gather twin."""
    pol = resolve_policy(policy, "attn")
    if pol.kernel == "pallas" and pol.backend == "mxu":
        return paged_decode_attention_kernel(q, k_pages, v_pages, block_table,
                                             seq_lens, policy=pol)
    return paged_decode_attention_xla(q, k_pages, v_pages, block_table,
                                      seq_lens, policy=pol)
