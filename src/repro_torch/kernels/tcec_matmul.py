"""K2 — TCEC matmul with the epilogue fused into the store.

Counterpart of ``repro.kernels.tcec_matmul.tcec_matmul_fused`` (bf16 words,
array rhs).  ``tcec_matmul_fused`` launches the CUDA kernel of
``csrc/tcec_matmul.cu`` on a CUDA tensor and runs ``tcec_matmul_plain`` on
a CPU tensor; there is no fallback from one to the other.

Shapes: a (m, k) or (b, m, k); b (k, n) or (b, k, n) (a batched rhs needs a
batched lhs); bias (n,); residual like the output.  Any float input dtype;
fp32 out, or ``out_dtype``.  The kernel reads fp32 or bf16 operands at their
own dtype — bf16 weights are never widened on the host.

The non-finite guard stays on the host, as in the reference: corrected
policies split sanitized operands (the kernel zeroes non-finite inputs in
registers and raises a device flag) and, when an input was non-finite, the
fp32 reference dot's ±inf/NaN entries — run through the same epilogue —
replace the kernel's at those positions.  Reading the flag is one host
sync per call under a corrected policy.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy
from repro_torch.core.tcec import nonfinite_guard, sanitize_nonfinite
from repro_torch.tcec.epilogue import ACTIVATIONS
from . import _build
from .tcec_core import dot_params, kernel_passes, policy_dot

__all__ = ["tcec_matmul_fused", "tcec_matmul_plain", "LAUNCHES"]

LAUNCHES = _build.counter("tcec_matmul")

_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
_FLOATS = (torch.float32, torch.bfloat16)
#: (m, k) | (b, m, k) against (k, n) | (b, k, n).
_EQ = "...mk,...kn->...mn"


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate (m,k)@(k,n) | (b,m,k)@(b,k,n) | (b,m,k)@(k,n); return
    (batch, m, n, k)."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"tcec matmul expects 2-D or 3-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() == 2 and b.dim() == 3:
        raise ValueError(f"broadcasting a 2-D lhs against a batched rhs is "
                         f"not supported: {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"contracting dims disagree: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch dims disagree: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    nb = a.shape[0] if a.dim() == 3 else 1
    return nb, m, n, k


def _needs_guard(pol: TcecPolicy) -> bool:
    return pol.backend == "mxu" and pol.error_correction


def _epilogue_ref(y: torch.Tensor, scale: float, bias, activation,
                  residual) -> torch.Tensor:
    if scale != 1.0:
        y = y * scale
    if bias is not None:
        y = y + bias.float()
    if activation is not None:
        y = ACTIVATIONS[activation](y)
    if residual is not None:
        y = y + residual.float()
    return y


def _matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 reference dot the non-finite guard takes its ±inf/NaN from."""
    return torch.matmul(a.float(), b.float())


def tcec_matmul_plain(a: torch.Tensor, b: torch.Tensor, policy: TcecPolicy,
                      *, bias=None, residual=None, scale: float = 1.0,
                      activation: Optional[str] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: ``policy_dot`` over the whole
    k on the sanitized operands (the kernel sums per k16 step; only the
    fp32 summation order differs), the epilogue, the guard."""
    _check_shapes(a, b)
    guarded = _needs_guard(policy)
    aa, bb = (sanitize_nonfinite(a), sanitize_nonfinite(b)) if guarded \
        else (a, b)
    epilogue = functools.partial(_epilogue_ref, scale=scale, bias=bias,
                                 activation=activation, residual=residual)
    y = policy_dot(aa, bb, _EQ, **dot_params(policy))
    out = epilogue(y).to(out_dtype or torch.float32)
    if guarded:
        out = nonfinite_guard(out, a, b, _matmul32, post=epilogue)
    return out


def _entry(passes: int):
    """The loaded library and its C entry point, argument types declared."""
    lib = _build.load("tcec_matmul", passes)
    fn = lib.repro_tcec_matmul
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cll, cll, cll,
                       ci, ci, ci, ctypes.c_float, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib, fn


def launcher(a, b, pol, bias=None, residual=None, scale=1.0,
             activation=None, out_dtype=None):
    """Validate a CUDA call and allocate its output; returns ``(out, flag,
    launch)`` where ``launch()`` enqueues the kernel on the current stream
    (counted, no host sync) and ``flag`` is the device int that a guarded
    policy's kernel sets on a non-finite input (``None`` when unguarded).
    ``tcec_matmul_fused`` is this plus the guard; timing code enqueues
    ``launch`` alone."""
    what = "tcec_matmul"
    passes = kernel_passes(pol, what)
    nb, m, n, k = _check_shapes(a, b)
    dev = a.device
    for name, x in (("a", a), ("b", b), ("bias", bias), ("residual", residual)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, a on {dev}")
        if x.dtype not in _FLOATS:
            raise ValueError(f"{what}: {name} dtype {x.dtype} not in {_FLOATS}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if activation not in _ACT_CODES:
        raise ValueError(f"{what}: unknown activation {activation!r}")
    o_dt = out_dtype or torch.float32
    if o_dt not in _FLOATS:
        raise ValueError(f"{what}: out dtype {o_dt} not in {_FLOATS}")
    out_shape = (nb, m, n) if a.dim() == 3 else (m, n)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"{what}: residual {tuple(residual.shape)} != "
                         f"output {out_shape}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"{what}: bias shape {tuple(bias.shape)} != ({n},)")
    out = torch.empty(out_shape, dtype=o_dt, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev) \
        if _needs_guard(pol) else None
    bf = torch.bfloat16
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if flag is None else flag.data_ptr(),
            m, n, k, nb,
            m * k if a.dim() == 3 else 0, k * n if b.dim() == 3 else 0, m * n,
            int(a.dtype == bf), int(b.dtype == bf), passes, float(scale),
            _ACT_CODES[activation],
            int(bias is not None and bias.dtype == bf),
            int(residual is not None and residual.dtype == bf),
            int(o_dt == bf))

    def launch():
        if out.numel() == 0:
            return
        lib, fn = _entry(passes)
        rc = fn(*args, _build.stream_ptr(dev))
        _build.check(lib, rc, what)
        LAUNCHES.hit()

    return out, flag, launch


def _launch(a, b, pol, bias, residual, scale, activation, out_dtype):
    out, flag, launch = launcher(a, b, pol, bias, residual, scale,
                                 activation, out_dtype)
    launch()
    if flag is not None:
        epilogue = functools.partial(_epilogue_ref, scale=scale, bias=bias,
                                     activation=activation, residual=residual)
        out = nonfinite_guard(out, a, b, _matmul32, post=epilogue,
                              finite=not bool(flag.item()))
    return out


def tcec_matmul_fused(a: torch.Tensor, b: torch.Tensor,
                      policy: TcecPolicy | str | None = None, *,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      scale: float = 1.0, activation: Optional[str] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """TCEC matmul with the epilogue applied at the store.

    A CUDA tensor launches the kernel (or raises on what it does not take:
    the vpu and int8 arms, non-contiguous operands); a CPU tensor runs the
    plain version.
    """
    pol = resolve_policy(policy)
    if a.is_cuda:
        return _launch(a, b, pol, bias, residual, scale, activation, out_dtype)
    return tcec_matmul_plain(a, b, pol, bias=bias, residual=residual,
                             scale=scale, activation=activation,
                             out_dtype=out_dtype)
