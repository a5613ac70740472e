"""The non-finite fix-up (``csrc/nonfinite_fixup.cu``): a corrected policy's
non-finite guard on the card, with no host read.

Counterpart of the ``lax.cond`` in ``repro.core.tcec.nonfinite_guard``.  A
corrected split schedule runs on sanitized operands; where the fp32 dot of
the original operands is not finite, that dot (through the call's epilogue)
replaces the schedule's value.  On the card a device flag says whether any
input was non-finite, and a kernel enqueued after the product reads it:
with the flag clear every block returns at once, so the common case costs
one short launch and no host sync.

  * ``nonfinite_flag(*xs)`` — the flag, an int32 device tensor, from torch
    ops on the inputs (for products whose kernel does not raise one itself);
  * ``nonfinite_fixup(out, a, b, flag)`` — the kernel for ``(batch, m, k) x
    (batch, k, n)`` operands given by strides (a 2-D operand broadcasts;
    a transposed rhs is a stride), fp32 output;
  * ``einsum_fixup(eq, out, a, b, flag)`` — the same for a two-operand
    einsum whose labels split into batch, row, column and contraction
    groups (the twin's guard on the card, ``repro_torch.tcec.frontend``);
  * ``nonfinite_fixup_plain`` — the plain version: the flag as a tensor,
    ``torch.where`` on it, no host read; bitwise what
    ``repro_torch.core.tcec.nonfinite_guard`` gives.

K2 (``tcec_matmul.tcec_matmul_fused``) enqueues the same kernel from its own
entry point, or folds it into its reduce kernel.
"""
from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import _build

__all__ = ["nonfinite_flag", "nonfinite_fixup", "einsum_fixup",
           "bmm_views", "nonfinite_fixup_plain", "LAUNCHES"]

#: Launches of the fix-up on its own (K2's own enqueue counts here too; its
#: folded form counts as ``tcec_matmul_reduce``).
LAUNCHES = _build.counter("nonfinite_fixup")

_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _entry():
    lib = _build.load("nonfinite_fixup", 1)
    fn = lib.repro_nonfinite_fixup
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _CI, _VP, _CI, _VP, _CI, _CI, _CI, _CI,
                       ctypes.POINTER(ctypes.c_longlong), _VP]
        fn.restype = _CI
    return lib, fn


def nonfinite_flag(*xs: torch.Tensor) -> torch.Tensor:
    """A ``(1,)`` int32 tensor on the inputs' device: 1 when any element of
    any input is ±inf or NaN.  Device ops only (no host read)."""
    bad = torch.zeros((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        bad = bad | torch.logical_not(torch.isfinite(x)).any()
    return bad.to(torch.int32).reshape(1)


def nonfinite_fixup_plain(out: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, flag: torch.Tensor,
                          ref_fn: Callable,
                          post: Optional[Callable] = None) -> torch.Tensor:
    """The fix-up in torch ops: where ``flag`` is set and ``ref_fn(a, b)``
    (the fp32 reference contraction) is not finite, ``post`` of it (the
    epilogue) replaces ``out``.  ``flag`` stays a tensor."""
    ref = ref_fn(a, b)
    fix = flag.reshape(()).bool() & torch.logical_not(torch.isfinite(ref))
    if post is not None:
        ref = post(ref)
    return torch.where(fix, ref.to(out.dtype), out)


def _operand3(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(batch, r, c) view of a 2-D or 3-D operand and its batch stride (0
    for a 2-D operand or a batch of one, which every batch shares)."""
    if x.dim() == 2:
        return x.unsqueeze(0), 0
    return x, 0 if x.shape[0] == 1 else x.stride(0)


def nonfinite_fixup(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    flag: torch.Tensor) -> torch.Tensor:
    """Enqueue the fix-up of ``out`` (fp32, (batch,) m, n) for ``a`` ((batch,)
    m, k) times ``b`` ((batch,) k, n) at fp32 or bf16, each given by its
    strides; ``flag`` a (1,) int32 device tensor.  Fixes ``out`` in place
    and returns it."""
    what = "nonfinite_fixup"
    if out.dtype != torch.float32:
        raise ValueError(f"{what}: out must be fp32, got {out.dtype}")
    for name, x in (("a", a), ("b", b)):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{what}: {name} dtype {x.dtype}")
        if x.device != out.device:
            raise ValueError(f"{what}: {name} on {x.device}, out on "
                             f"{out.device}")
    if flag.dtype != torch.int32 or flag.device != out.device:
        raise ValueError(f"{what}: flag must be an int32 tensor on "
                         f"{out.device}")
    a3, sab = _operand3(a)
    b3, sbb = _operand3(b)
    o3, sob = _operand3(out)
    batch, m, n = o3.shape
    k = a3.shape[-1]
    if tuple(a3.shape[1:]) != (m, k) or tuple(b3.shape[1:]) != (k, n) or \
            a3.shape[0] not in (1, batch) or b3.shape[0] not in (1, batch):
        raise ValueError(f"{what}: {tuple(a.shape)} x {tuple(b.shape)} -> "
                         f"{tuple(out.shape)}")
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(
        sab, a3.stride(1), a3.stride(2), sbb, b3.stride(1), b3.stride(2),
        sob, o3.stride(1), o3.stride(2))
    lib, fn = _entry()
    bf = torch.bfloat16
    rc = fn(flag.data_ptr(), a3.data_ptr(), int(a.dtype == bf), b3.data_ptr(),
            int(b.dtype == bf), o3.data_ptr(), batch, m, n, k, strides,
            _build.stream_ptr(out.device))
    _build.check(lib, rc, what)
    LAUNCHES.hit()
    return out


def _merge(x: torch.Tensor, labels: str, groups: Sequence[str]
           ) -> Optional[torch.Tensor]:
    """``x`` (dims named by ``labels``) as a 3-D view with one dim per
    group of labels, or None when a group's dims do not merge into one
    stride."""
    sizes: List[int] = []
    strides: List[int] = []
    for grp in groups:
        size, stride = 1, 0
        for c in reversed(grp):          # innermost label last
            i = labels.index(c)
            s, st = x.shape[i], x.stride(i)
            if s == 1:
                continue
            if size == 1:
                size, stride = s, st
            elif st == stride * size:
                size *= s
            else:
                return None
        sizes.append(size)
        strides.append(stride)
    return x.as_strided(sizes, strides)


def bmm_views(eq: str, out: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """For ``out = einsum(eq, a, b)``: ``(out, o3, a3, b3)`` with ``o3 (B,
    M, N)`` a view of the returned ``out`` (``out`` itself, or a copy where
    its layout does not merge) and ``a3 (B, M, K)``, ``b3 (B, K, N)`` views
    of the operands (copies where theirs do not merge), so that ``o3 ==
    a3 @ b3``.  Every label must be a batch label (in a, b and out), a row
    label (a and out), a column label (b and out) or a contraction label (a
    and b)."""
    ins, io = eq.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    if any(len(set(x)) != len(x) for x in (ia, ib, io)):
        raise NotImplementedError(f"bmm_views: repeated labels in {eq!r}")
    batch = "".join(c for c in io if c in ia and c in ib)
    rows = "".join(c for c in io if c in ia and c not in ib)
    cols = "".join(c for c in io if c in ib and c not in ia)
    ks = "".join(c for c in ia if c in ib and c not in io)
    if set(ia) != set(batch + rows + ks) or set(ib) != set(batch + ks + cols):
        raise NotImplementedError(
            f"bmm_views: {eq!r} sums a label of one operand only")
    o3 = _merge(out, io, (batch, rows, cols))
    if o3 is None:
        # A copy laid out (batch, rows, cols), viewed back in out's order.
        perm = [io.index(c) for c in batch + rows + cols]
        out = out.permute(perm).contiguous().permute(
            [perm.index(i) for i in range(len(io))])
        o3 = _merge(out, io, (batch, rows, cols))
    a3 = _merge(a, ia, (batch, rows, ks))
    if a3 is None:
        a3 = a.permute([ia.index(c) for c in batch + rows + ks]).reshape(
            o3.shape[0], o3.shape[1], -1)
    b3 = _merge(b, ib, (batch, ks, cols))
    if b3 is None:
        b3 = b.permute([ib.index(c) for c in batch + ks + cols]).reshape(
            o3.shape[0], -1, o3.shape[2])
    return out, o3, a3, b3


def einsum_fixup(eq: str, out: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """The fix-up of ``out = einsum(eq, a, b)`` (fp32, labels as
    ``bmm_views`` takes them); returns the fixed output."""
    if out.numel() == 0:
        return out
    out, o3, a3, b3 = bmm_views(eq, out, a, b)
    nonfinite_fixup(o3, a3, b3, flag)
    return out
