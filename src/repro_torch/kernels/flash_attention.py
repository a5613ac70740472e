"""K3 — flash attention forward with policy-selected QK^T/PV precision.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (forward).
``flash_attention`` launches the CUDA kernel of ``csrc/flash_attention.cu``
on CUDA tensors and runs ``flash_attention_plain`` on CPU tensors.

Layout (the reference's): q (b, h, sq, d); k (b, kvh, skv, d) and v (b,
kvh, skv, dv) with h % kvh == 0 — GQA reads kv head ``hh // rep``, no head
copies.  The kernel takes d, dv <= 256 (a build per bucket of max(d, dv):
32, 64, 128, 256).  The
kernel takes strided q/k/v (the model passes transposed views) and writes
its fp32 output through strides too.  ``kv_len`` masks kv columns >= kv_len
and is a runtime argument; fully masked rows return zeros.  Output dtype
follows the reference: fp32 for corrected/vpu policies, q.dtype for plain.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy
from . import _build
from .tcec_core import dot_params, kernel_passes, policy_dot

__all__ = ["flash_attention", "flash_attention_plain", "LAUNCHES", "BLOCK_KV",
           "NEG_INF"]

LAUNCHES = _build.counter("flash_attention")
NEG_INF = -1e30
#: The kernel's kv tile; the plain version runs its online softmax over
#: blocks of the same width, so the two round P at the same places.
BLOCK_KV = 64
#: The largest head dims (d and dv) the kernel takes.
MAX_HEAD_DIM = 256


def _out_dtype(pol: TcecPolicy, q: torch.Tensor) -> torch.dtype:
    if pol.error_correction or pol.backend == "vpu":
        return torch.float32
    return q.dtype


def _check(q, k, v, kv_len):
    b, h, sq, d = q.shape
    _, kvh, skv, _ = k.shape
    if h % kvh != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} disagree")
    if kv_len is None:
        kv_len = skv
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {skv}]")
    return kv_len


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          policy: TcecPolicy, causal: bool = True,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: online softmax over kv blocks
    of ``BLOCK_KV`` columns, QK^T and PV through ``policy_dot``.  Returns
    fp32 (the kernel's output, before the dtype contract)."""
    kv_len = _check(q, k, v, kv_len)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / (d ** 0.5)
    kw = dot_params(policy)
    kk = k.float().repeat_interleave(rep, dim=1)
    vv = v.float().repeat_interleave(rep, dim=1)
    q32 = q.float()
    m = torch.full((b, h, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for j0 in range(0, kv_len, BLOCK_KV):
        kb, vb = kk[:, :, j0:j0 + BLOCK_KV], vv[:, :, j0:j0 + BLOCK_KV]
        s = policy_dot(q32, kb, "bhqd,bhkd->bhqk", **kw) * scale
        cols = j0 + torch.arange(kb.shape[2], device=q.device)[None]
        valid = cols < kv_len
        if causal:
            valid = valid & (rows >= cols)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(m_new > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + policy_dot(p, vb, "bhqk,bhkd->bhqd", **kw)
        m = m_new
    return torch.where(l > 0.0, acc / torch.where(l > 0.0, l, 1.0), 0.0)


def _entry(passes: int):
    lib = _build.load("flash_attention", passes)
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, ci, ctypes.POINTER(ctypes.c_longlong),
                       vp]
        fn.restype = ci
    return lib, fn


def _launch(q, k, v, pol, causal, kv_len):
    what = "flash_attention"
    passes = kernel_passes(pol, what)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if k.shape[-1] != d:
        raise ValueError(f"{what}: q head dim {d}, k head dim {k.shape[-1]}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: head dims d={d}, dv={dv} — the kernel takes d, dv <= "
            f"{MAX_HEAD_DIM}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{what}: {name} must match q's device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {q.dtype} not fp32/bf16")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{what}: {name}'s last dim must be contiguous")
    # Output (b, sq, h, d): the layout the model reshapes next, written
    # through (batch, head, seq) strides.
    out = torch.empty((b, sq, h, dv), dtype=torch.float32, device=q.device)
    ot = out.transpose(1, 2)
    if out.numel() == 0:
        return ot
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *ot.stride()[:3])
    lib, fn = _entry(passes)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            h // kvh, sq, skv, d, dv, kv_len, int(causal), 1.0 / (d ** 0.5),
            int(q.dtype == torch.bfloat16), passes, strides,
            _build.stream_ptr(q.device))
    _build.check(lib, rc, what)
    LAUNCHES.hit()
    return ot


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    policy: TcecPolicy | str | None = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Fused flash attention: q (b, h, sq, d), k (b, kvh, skv, d), v (b,
    kvh, skv, dv) -> (b, h, sq, dv).  ``policy`` is resolved at the
    ``"attn"`` site when not given.  CUDA tensors launch the kernel (the vpu
    arm, bf16x9 and head dims above 256 raise); CPU tensors run the plain
    version."""
    pol = resolve_policy(policy, "attn")
    kv_len = _check(q, k, v, kv_len)
    if q.is_cuda:
        out = _launch(q, k, v, pol, causal, kv_len)
    else:
        out = flash_attention_plain(q, k, v, pol, causal, kv_len)
    return out.to(_out_dtype(pol, q))
