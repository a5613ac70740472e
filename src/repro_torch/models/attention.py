"""GQA attention with paged KV caches (counterpart of
``repro.models.attention``: ``chunked_attention``, ``decode_attention`` and
``gqa_apply``'s prefill and paged branches).

Attention is a TCEC site: every QK^T/PV contraction resolves the ``"attn"``
policy.  A policy with ``kernel == "pallas"`` sends prefill attention to the
flash kernel (K3) and paged decode to the paged-attention kernel (K4); any
other policy runs the twins here, whose contractions go through
``repro_torch.tcec.einsum``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import tcec
from repro_torch.configs.base import ArchConfig
from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy
from .base import apply_rope, dense, largest_divisor_leq, rope_cos_sin

NEG_INF = -1e30


def _plain(pol: TcecPolicy) -> bool:
    return pol.backend == "mxu" and not pol.error_correction


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, q_chunk: int = 512, kv_chunk: int = 1024,
                      kv_len: Optional[int] = None,
                      policy: TcecPolicy | str | None = None) -> torch.Tensor:
    """q (b, sq, h, d), k/v (b, skv, kvh, d) -> (b, sq, h, d).

    ``kernel == "pallas"`` dispatches to the flash kernel with its fixed
    blocks (64 x 64; the port has no autotuner yet).  Otherwise the twin:
    an online softmax over (q_chunk, kv_chunk) tiles, GQA by reshape.
    Causal self-attention with several q chunks visits only the
    lower-triangular chunk pairs and, under the plain policy, rounds the
    probability tile to bf16 — the reference's pair path.  Fully masked
    rows emit zeros.
    """
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    dv = v.shape[-1]
    rep = h // kvh
    scale = 1.0 / (d ** 0.5)
    pol = resolve_policy(policy, "attn")
    if pol.kernel == "pallas" and pol.backend == "mxu":
        from repro_torch.kernels.flash_attention import flash_attention
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, policy=pol,
                            kv_len=kv_len)
        return o.transpose(1, 2)
    q_chunk = largest_divisor_leq(sq, q_chunk)
    kv_chunk = largest_divisor_leq(skv, kv_chunk)
    nq, nk = sq // q_chunk, skv // kv_chunk
    pair = causal and sq == skv and nq > 1 and kv_len is None
    dev = q.device
    qc = q.reshape(b, nq, q_chunk, kvh, rep, d)
    kc = k.reshape(b, nk, kv_chunk, kvh, d)
    vc = v.reshape(b, nk, kv_chunk, kvh, dv)
    outs = []
    for i in range(nq):
        q_off = i * q_chunk
        m = torch.full((b, kvh, rep, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, rep, q_chunk), device=dev)
        acc = torch.zeros((b, kvh, rep, q_chunk, dv), device=dev)
        for j in range(nk):
            k_off = j * kv_chunk
            if pair and k_off >= (i + 1) * q_chunk:
                break
            s = tcec.einsum("bqgrd,bkgd->bgrqk", qc[:, i], kc[:, j],
                            site="attn", policy=pol) * scale
            if causal or kv_len is not None:
                rows = q_off + torch.arange(q_chunk, device=dev)[:, None]
                cols = k_off + torch.arange(kv_chunk, device=dev)[None]
                valid = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                                   device=dev)
                if kv_len is not None:
                    valid = valid & (cols < kv_len)
                if causal:
                    valid = valid & (rows >= cols)
                s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            # rows with no valid column yet must not attend
            p = torch.where((m_new > 0.5 * NEG_INF)[..., None],
                            torch.exp(s - m_new[..., None]), 0.0)
            if pair and _plain(pol):
                p = p.to(torch.bfloat16)       # bf16 probability tile
            l = l * alpha + p.sum(-1, dtype=torch.float32)
            pv = tcec.einsum("bgrqk,bkgd->bgrqd", p, vc[:, j], site="attn",
                             policy=pol)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = torch.where((l > 0.0)[..., None],
                          acc / torch.clamp_min(l, 1e-30)[..., None], 0.0)
        outs.append(out)                        # (b, kvh, rep, qc, dv)
    out = torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5)
    out = out.reshape(b, sq, h, dv)
    return out if not _plain(pol) else out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_index: torch.Tensor,
                     policy: TcecPolicy | str | None = None) -> torch.Tensor:
    """One-token attention against a cache: q (b, 1, h, d); k/v_cache
    (b, S, kvh, d); positions > cache_index masked; a negative index emits
    zeros."""
    b, _, h, d = q.shape
    _, S, kvh, _ = k_cache.shape
    rep = h // kvh
    scale = 1.0 / (d ** 0.5)
    pol = resolve_policy(policy, "attn")
    qh = q.reshape(b, kvh, rep, d)
    s = tcec.einsum("bgrd,bsgd->bgrs", qh, k_cache, site="attn",
                    policy=pol) * scale
    valid = torch.arange(S, device=q.device)[None] <= cache_index[:, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully masked rows: softmax of all-NEG_INF is uniform — emit zeros
    p = torch.where(valid.any(-1)[:, None, None, None], p, 0.0)
    o = tcec.einsum("bgrs,bsgd->bgrd", p, v_cache, site="attn", policy=pol)
    o = o.reshape(b, 1, h, d)
    return o if not _plain(pol) else o.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projection weights under the reference's parameter names."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)
        self.wq = param(d, h * hd)
        self.wk = param(d, kvh * hd)
        self.wv = param(d, kvh * hd)
        self.wo = param(h * hd, d)
        if cfg.qkv_bias:
            self.bq = param(h * hd)
            self.bk = param(kvh * hd)
            self.bv = param(kvh * hd)
        else:
            self.bq = self.bk = self.bv = None


def gqa_apply(p: Attention, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, cache: Optional[Dict] = None,
              causal: bool = True, emit_kv: bool = False,
              block_table: Optional[torch.Tensor] = None,
              seq_lens: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.  Without a cache: prefill over x (b, s, d), optionally
    emitting its K/V.  With a paged cache (``{"k_pages", "v_pages"}``): the
    new K/V are appended at each slot's ``seq_lens`` position (in place)
    and one-token decode reads the pages through the block table."""
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    site = "attn"
    q = dense(x, p.wq, site, p.bq).reshape(b, s, h, hd)
    k = dense(x, p.wk, site, p.bk).reshape(b, s, kvh, hd)
    v = dense(x, p.wv, site, p.bv).reshape(b, s, kvh, hd)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        if "k_pages" not in cache:
            raise NotImplementedError(
                "contiguous (non-paged) decode caches are not ported yet")
        if s != 1:
            raise NotImplementedError(
                "chunked prefill (paged_prefill_attention) is not ported yet")
        from repro_torch.serving import paged_attention as _pa
        from repro_torch.serving import paged_cache as _pc
        k_pages = _pc.append_pages(cache["k_pages"], k, block_table, seq_lens)
        v_pages = _pc.append_pages(cache["v_pages"], v, block_table, seq_lens)
        o = _pa.paged_decode_attention(
            q[:, 0], k_pages, v_pages, block_table,
            seq_lens.to(torch.int32) + 1)[:, None]
        y = dense(o.reshape(b, s, h * hd), p.wo, site)
        return y.to(x.dtype), {"k_pages": k_pages, "v_pages": v_pages}

    o = chunked_attention(q, k, v, causal=causal)
    new_cache = {"k": k, "v": v} if emit_kv else None
    y = dense(o.reshape(b, s, h * hd), p.wo, site)
    return y.to(x.dtype), new_cache
