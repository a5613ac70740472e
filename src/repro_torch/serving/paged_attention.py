"""Paged decode attention — block-table reads inside the kernel, QK^T/PV on
the shared TCEC split schedule (counterpart of
``repro.serving.paged_attention``, GQA with unquantized pages).

  * ``paged_decode_attention_kernel`` — K4: the CUDA kernel of
    ``csrc/paged_attention.cu`` on CUDA tensors, its plain version
    ``paged_decode_attention_plain`` on CPU tensors;
  * ``paged_decode_attention_xla`` — the gather twin: materialize the
    block table's pages and run the contiguous ``decode_attention``;
  * ``paged_decode_attention`` — the dispatch: a policy with
    ``kernel == "pallas"`` on the tensor-core backend takes the kernel,
    anything else the twin.

Not ported yet: MLA (``paged_mla_decode_attention``, the kernel's second
score pair), int8 pages with per-page scales, ``paged_prefill_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.tcec_core import dot_params, kernel_passes, policy_dot
from .paged_cache import gather_pages

__all__ = ["paged_decode_attention", "paged_decode_attention_kernel",
           "paged_decode_attention_plain", "paged_decode_attention_xla",
           "LAUNCHES", "CHUNK"]

LAUNCHES = _build.counter("paged_attention")
NEG_INF = -1e30
#: Positions per online-softmax step, in the kernel and its plain version
#: (one page, and so the reference's blocking, when page_size == 16).
CHUNK = 16
_HEAD_DIMS = (64,)


def _corrected(pol: TcecPolicy) -> bool:
    return pol.error_correction or pol.backend == "vpu"


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 seq_lens: torch.Tensor, *, scale: float,
                                 policy: TcecPolicy) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: gathered pages, online softmax
    over ``CHUNK``-position steps, QK^T/PV through ``policy_dot``.
    q (b, h, d) -> (b, h, dv) fp32."""
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    rep = h // kvh
    kw = dot_params(policy)
    kv = gather_pages(k_pages, block_table).float().transpose(1, 2)
    vv = gather_pages(v_pages, block_table).float().transpose(1, 2)
    qh = q.float().reshape(b, kvh, rep, d)
    lens = seq_lens.to(torch.int64)[:, None, None, None]
    m = torch.full((b, kvh, rep, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, rep, 1), device=q.device)
    acc = torch.zeros((b, kvh, rep, vv.shape[-1]), device=q.device)
    n_pos = int(seq_lens.max()) if seq_lens.numel() else 0
    for p0 in range(0, min(n_pos, kv.shape[2]), CHUNK):
        kb, vb = kv[:, :, p0:p0 + CHUNK], vv[:, :, p0:p0 + CHUNK]
        s = policy_dot(qh, kb, "bgrd,bgsd->bgrs", **kw) * scale
        cols = p0 + torch.arange(kb.shape[2], device=q.device)
        s = torch.where(cols < lens, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(m_new > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + policy_dot(p, vb, "bgrs,bgsd->bgrd", **kw)
        m = m_new
    out = torch.where(l > 0.0, acc / torch.where(l > 0.0, l, 1.0), 0.0)
    return out.reshape(b, h, vv.shape[-1])


def _entry(passes: int):
    lib = _build.load("paged_attention", passes)
    fn = lib.repro_paged_decode_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, ci, vp]
        fn.restype = ci
    return lib, fn


def _launch(q, k_pages, v_pages, block_table, seq_lens, scale, pol):
    what = "paged_decode_attention"
    passes = kernel_passes(pol, what)
    b, h, d = q.shape
    _, page, kvh, dk = k_pages.shape
    if d not in _HEAD_DIMS or dk != d or v_pages.shape != k_pages.shape:
        raise NotImplementedError(
            f"{what}: head dim {d} — the kernel takes k/v pages of one shape "
            f"with d in {_HEAD_DIMS}")
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
    qf = q.float().contiguous()
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry(passes)
    rc = fn(qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, kvh, h // kvh, d, page, block_table.shape[1], float(scale),
            int(k_pages.dtype == torch.bfloat16), passes,
            _build.stream_ptr(q.device))
    _build.check(lib, rc, what)
    LAUNCHES.hit()
    return out


def paged_decode_attention_kernel(q, k_pages, v_pages, block_table, seq_lens,
                                  *, scale: Optional[float] = None,
                                  policy: TcecPolicy | str | None = None
                                  ) -> torch.Tensor:
    """Fused paged decode attention (one query token per request).

    q ``(b, h, d)``; ``k_pages``/``v_pages (P, page, kvh, d)``;
    ``block_table (b, npages)`` int32; ``seq_lens (b,)`` int32 — request
    ``i`` attends to its first ``seq_lens[i]`` positions; a zero length
    emits zeros.  Returns ``(b, h, d)`` fp32 for corrected/vpu policies,
    ``q.dtype`` for the plain bf16 policy.
    """
    pol = resolve_policy(policy, "attn")
    b, h, d = q.shape
    if h % k_pages.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k_pages.shape[2]}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.is_cuda:
        out = _launch(q, k_pages, v_pages, block_table, seq_lens, scale, pol)
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
