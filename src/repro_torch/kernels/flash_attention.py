"""K3 — flash attention forward with policy-selected QK^T/PV precision.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (forward).
``flash_attention`` launches the CUDA kernels of ``csrc/flash_attention.cu``
on CUDA tensors and runs ``flash_attention_plain`` on CPU tensors.

Layout (the reference's): q (b, h, sq, d); k (b, kvh, skv, d) and v (b,
kvh, skv, dv) with h % kvh == 0 — GQA reads kv head ``hh // rep``, no head
copies.  The kernel takes d, dv <= 256 (a build per bucket of max(d, dv):
32, 64, 128, 256), strided q/k/v (the model passes transposed views), and
writes its fp32 output through strides too.  ``kv_len`` masks kv columns >=
kv_len and is a runtime argument; fully masked rows return zeros.  Output
dtype follows the reference: fp32 for corrected/vpu policies, q.dtype for
plain.

``k3_plan`` chooses the kernel's q tile (16 or 32 rows: four warps per 16
rows, each taking a quarter of every kv tile) and, where the (b, h, q
tile) grid would not fill the card, splits each q tile's causal kv range,
in whole ``BLOCK_KV`` tiles, across blocks; each split starts its
running max from the max of the splits before it (a max pass computes
them), so P is rounded where the reference rounds it, and a merge combines
the splits' (m, l, acc) in split order.  ``k3_passes`` names the passes
the kernel runs.  The plain version follows the same plan, tiles, max rule
and merge order.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy
from . import _build
from .tcec_core import dot_params, kernel_passes, policy_dot
from .tcec_matmul import k2_passes, plan_sms

__all__ = ["flash_attention", "flash_attention_plain", "k3_plan", "k3_passes",
           "K3Plan", "LAUNCHES", "BLOCK_KV", "NEG_INF"]

LAUNCHES = _build.counter("flash_attention")
NEG_INF = -1e30
#: The kernel's kv tile; the plain version runs its online softmax over
#: blocks of the same width, so the two round P at the same places.
BLOCK_KV = 64
#: The largest head dims (d and dv) the kernel takes.
MAX_HEAD_DIM = 256
#: Query rows of a row group: four warps, one m16 tile each, each warp
#: taking 16 columns of every kv tile.  A block has one or two row groups.
K3_GROUP_ROWS = 16
K3_GROUP_WARPS = 4
#: K3 splits kv ranges until its grid reaches this many blocks per SM.
K3_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """How K3 runs a call: q tiles of ``block_q`` rows (``warps`` warps,
    four per 16 rows), ``q_tiles`` of them; the longest q tile's kv range
    is ``kv_tiles`` tiles of ``BLOCK_KV``; each q tile's range is cut into
    splits of ``per`` tiles (split s covers tiles [s * per, (s + 1) *
    per)), at most ``splits``; ``blocks`` is the main kernel's grid (b * h
    * q_tiles * splits, the blocks past a short q tile's range included)."""
    block_q: int
    warps: int
    q_tiles: int
    kv_tiles: int
    splits: int
    per: int
    blocks: int


def k3_plan(b: int, h: int, kvh: int, sq: int, skv: int, causal: bool,
            d: int, dv: int, sms: int = 132, *,
            kv_len: Optional[int] = None) -> K3Plan:
    """K3's plan for q (b, h, sq, d) against k/v (b, kvh, skv, d|dv) on a
    card of ``sms`` SMs: q tiles of two row groups (one for a prompt of at
    most 16 rows); where the (b, h, q tile) grid gives fewer than
    ``K3_BLOCKS_PER_SM`` blocks per SM, as many splits of whole kv tiles as
    bring it there.  A plain function of its arguments."""
    if h % kvh or not (0 < d <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"k3_plan: h={h}, kvh={kvh}, d={d}, dv={dv}")
    kv_len = skv if kv_len is None else kv_len
    groups = 1 if sq <= K3_GROUP_ROWS else 2
    block_q = K3_GROUP_ROWS * groups
    q_tiles = -(-sq // block_q)
    kv_end = min(kv_len, skv, sq if causal else skv)
    kv_tiles = -(-kv_end // BLOCK_KV)
    units = b * h * q_tiles
    want = -(-K3_BLOCKS_PER_SM * sms // max(1, units))
    splits = max(1, min(want, kv_tiles))
    per = max(1, -(-kv_tiles // splits))
    splits = max(1, -(-kv_tiles // per))
    return K3Plan(block_q, K3_GROUP_WARPS * groups, q_tiles, kv_tiles,
                  splits, per, units * splits)


Passes = Tuple[Tuple[int, int], ...]


def k3_passes(policy: TcecPolicy, q_dtype: torch.dtype,
              kv_dtype: torch.dtype) -> Tuple[Passes, Passes]:
    """The schedule passes K3 runs, (q·K^T, P·V), each as (lhs word, rhs
    word) in schedule order — ``k2_passes``'s rule: a bf16 operand is its
    own word 0, so a pass reading another of its words is skipped.  P is
    fp32."""
    return (k2_passes(policy, q_dtype, kv_dtype),
            k2_passes(policy, torch.float32, kv_dtype))


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
    """The kernel's arithmetic in torch ops, on ``k3_plan``'s splits (for
    the card q lies on; for a CPU tensor, an H100's 132 SMs): an online
    softmax over kv tiles of ``BLOCK_KV`` columns, QK^T and PV through
    ``policy_dot``; at each split's first tile (l, acc) start again from
    zero and m carries on (the max of the tiles before it, as the kernel's
    max pass gives it); the splits' (m, l, acc) merged in split order.
    Returns fp32 (the kernel's output, before the dtype contract)."""
    kv_len = _check(q, k, v, kv_len)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // kvh
    plan = k3_plan(b, h, kvh, sq, skv, causal, d, dv, plan_sms(q.device),
                   kv_len=kv_len)
    scale = 1.0 / (d ** 0.5)
    kw = dot_params(policy)
    kk = k.float().repeat_interleave(rep, dim=1)
    vv = v.float().repeat_interleave(rep, dim=1)
    q32 = q.float()
    dev = q.device
    m = torch.full((b, h, sq, 1), NEG_INF, device=dev)
    l = torch.zeros((b, h, sq, 1), device=dev)
    acc = torch.zeros((b, h, sq, dv), device=dev)
    rows = torch.arange(sq, device=dev)[:, None]
    parts = []
    for j in range(plan.kv_tiles):
        if j and j % plan.per == 0:
            parts.append((m, l, acc))
            l, acc = torch.zeros_like(l), torch.zeros_like(acc)
        j0 = j * BLOCK_KV
        kb, vb = kk[:, :, j0:j0 + BLOCK_KV], vv[:, :, j0:j0 + BLOCK_KV]
        s = policy_dot(q32, kb, "bhqd,bhkd->bhqk", **kw) * scale
        cols = j0 + torch.arange(kb.shape[2], device=dev)[None]
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
    parts.append((m, l, acc))
    big_m = parts[0][0]
    for m_s, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m_s)
    l = torch.zeros_like(l)
    acc = torch.zeros_like(acc)
    for m_s, l_s, acc_s in parts:
        w = torch.where(m_s > 0.5 * NEG_INF, torch.exp(m_s - big_m), 0.0)
        l = l + l_s * w
        acc = acc + acc_s * w
    return torch.where(l > 0.0, acc / torch.where(l > 0.0, l, 1.0), 0.0)


def _workspace_floats(rows: int, plan: K3Plan, dv: int) -> int:
    """Floats of a split call's workspace (``csrc/flash_attention.cu``'s
    ``Work``): each split's row max from the max pass, and its m, l and
    acc, each part on a 16-byte boundary."""
    if plan.splits == 1:
        return 0

    def round4(n):
        return -(-n // 4) * 4
    return (round4(rows * (plan.splits - 1)) + 2 * round4(rows * plan.splits)
            + rows * plan.splits * dv)


def _entry(passes: int):
    lib = _build.load("flash_attention", passes)
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ci,
                       ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), vp]
        fn.restype = ci
    return lib, fn


def launcher(q, k, v, pol, causal, kv_len):
    """Validate a CUDA call, plan it (``k3_plan``) and allocate its output
    and workspace; returns ``(out, launch)`` where ``launch()`` enqueues the
    plan's kernels in one host call (counted once, no host sync).
    ``launch.plan`` is the plan; ``out`` is (b, h, sq, dv) fp32."""
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
    if b * h > 65535:
        raise ValueError(f"{what}: b * h = {b * h} > 65535")
    plan = k3_plan(b, h, kvh, sq, skv, causal, d, dv, plan_sms(q.device),
                   kv_len=kv_len)
    # Output (b, sq, h, d): the layout the model reshapes next, written
    # through (batch, head, seq) strides.
    out = torch.empty((b, sq, h, dv), dtype=torch.float32, device=q.device)
    ot = out.transpose(1, 2)
    n_ws = _workspace_floats(b * h * sq, plan, dv)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *ot.stride()[:3])

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry(passes)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ws.data_ptr(), n_ws, b, h, h // kvh, sq, skv, d, dv, kv_len,
                int(causal), 1.0 / (d ** 0.5), int(q.dtype == torch.bfloat16),
                passes, plan.warps, plan.splits, plan.per, strides,
                _build.stream_ptr(q.device))
        _build.check(lib, rc, what)
        LAUNCHES.hit()

    launch.plan = plan
    return ot, launch


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
        out, launch = launcher(q, k, v, pol, causal, kv_len)
        launch()
    else:
        out = flash_attention_plain(q, k, v, pol, causal, kv_len)
    return out.to(_out_dtype(pol, q))
