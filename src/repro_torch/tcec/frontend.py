"""``repro_torch.tcec.einsum`` — the single policy-aware einsum frontend.

Counterpart of ``repro.tcec.frontend`` (forward only; the shared backward
comes with the training slice).  The call

    tcec.einsum(eq, a, b, site="ffn", epilogue=Epilogue(bias=b_ffn))

1. resolves the ``TcecPolicy`` from the explicit argument or the active
   ``policy_scope`` for ``site``;
2. plans the backend (``repro_torch.tcec.planner``): fp32 / split twin /
   the CUDA TCEC matmul kernel;
3. runs it, with the epilogue fused into the kernel's store or applied
   right after the twin's accumulate.

Operands may be lazy ``FragmentOperand`` rules: the twin splits the built
rule (``FragmentOperand.build``), as the reference's XLA path does; on the
``"pallas_fragment"`` plan the rhs rule goes to the kernel as ``frag=`` and
is never built (on a CPU tensor the kernel's plain version evaluates the
rule).

Plain (``passes == 1``, tensor-core) policies have two arithmetic
conventions on the twin, kept apart by ``precision=``:

  * ``"native"`` (default) — operands cast to the matrix unit's native
    dtype (``mma_dtype``: bf16 on a CUDA device, fp32 on the CPU, as the
    reference uses fp32 on its CPU backend), fp32 accumulate.  The model
    path.
  * ``"strict"`` — operands always split into the policy's bf16 words,
    whatever the device: the emulation semantics the structured ops'
    non-kernel path runs.

Corrected and vpu policies are identical under both conventions.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import string
from typing import Dict, List, Optional

import torch

from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy
from repro_torch.core.tcec import split_contract
from repro_torch.kernels.nonfinite import einsum_fixup, nonfinite_flag
from .epilogue import Epilogue, NO_EPILOGUE
from .operands import FragmentOperand
from .planner import parse_equation, plan_einsum

__all__ = ["einsum", "matmul", "mma_dtype", "trace_plans", "PlanRecord",
           "wide_weight_policy"]


def wide_weight_policy(pol: TcecPolicy, w_dtype: torch.dtype) -> TcecPolicy:
    """The wide-weight contract for layer-level callers (``base.dense``,
    tied LM heads): an uncorrected twin policy never silently rounds wide
    (fp32) weights to the matrix unit's native dtype — swap in the fp32
    vpu executor instead.  Kernel policies keep their path."""
    if (pol.backend == "mxu" and not pol.error_correction
            and pol.word_dtype == "bf16"
            and pol.kernel != "pallas"
            and w_dtype != torch.bfloat16):
        return dataclasses.replace(pol, backend="vpu", kernel="xla")
    return pol


def mma_dtype(device: torch.device) -> torch.dtype:
    """Native input dtype of the matrix unit on ``device``: bf16 on a CUDA
    device, fp32 on the CPU (matching the reference's CPU backend)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


# ---------------------------------------------------------------------------
# Plan tracing — lets tests assert which sites the frontend saw.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanRecord:
    eq: str
    site: Optional[str]
    policy: TcecPolicy
    backend: str            # the executor: "xla" | "pallas" | "pallas_fragment"


_TRACE: contextvars.ContextVar[Optional[List[PlanRecord]]] = \
    contextvars.ContextVar("repro_torch_tcec_trace", default=None)


@contextlib.contextmanager
def trace_plans():
    """Record every frontend call made inside the context."""
    log: List[PlanRecord] = []
    token = _TRACE.set(log)
    try:
        yield log
    finally:
        _TRACE.reset(token)


# ---------------------------------------------------------------------------
# Executors.
# ---------------------------------------------------------------------------

def _contract(eq: str, a: torch.Tensor, b: torch.Tensor,
              pol: TcecPolicy, precision: str = "native") -> torch.Tensor:
    """One policy-selected contraction, fp32 result (the twin executor)."""
    if pol.backend == "vpu":
        return torch.einsum(eq, a.float(), b.float())
    if pol.word_dtype != "bf16":
        raise NotImplementedError(
            f"word_dtype={pol.word_dtype!r} policies are not ported yet")
    if pol.passes == 1 and precision == "native":
        dt = mma_dtype(a.device)
        return torch.einsum(eq, a.to(dt).float(), b.to(dt).float())
    return split_contract(eq, a, b, pol,
                          guard=_device_guard if a.is_cuda else None)


def _device_guard(eq: str, out: torch.Tensor, a32: torch.Tensor,
                  b32: torch.Tensor) -> Optional[torch.Tensor]:
    """The twin's non-finite guard on the card: a device flag and the
    fix-up kernel, no host read.  None (the host check) for an equation the
    fix-up cannot read as a batched product: one that sums a label of one
    operand only or repeats a label."""
    try:
        return einsum_fixup(eq, out, a32, b32, nonfinite_flag(a32, b32))
    except NotImplementedError:
        return None


def _run_kernel(pattern: str, pol: TcecPolicy, a: torch.Tensor,
                b: Optional[torch.Tensor], ep: Epilogue,
                frag: Optional[FragmentOperand] = None) -> torch.Tensor:
    """The CUDA TCEC matmul kernel (its plain version on a CPU tensor),
    epilogue fused into the store; ``frag`` (with ``b`` None): the rhs rule
    made in the kernel."""
    from repro_torch.kernels.tcec_matmul import tcec_matmul_fused
    kw = dict(frag=frag, bias=ep.bias, scale=float(ep.scale),
              activation=ep.activation, out_dtype=ep.out_dtype)
    if pattern == "fold":
        lead = a.shape[:-1]
        a2 = a.reshape(-1, a.shape[-1])
        r2 = None if ep.residual is None \
            else ep.residual.reshape(-1, ep.residual.shape[-1])
        out = tcec_matmul_fused(a2, b, pol, residual=r2, **kw)
        return out.reshape(*lead, out.shape[-1])
    return tcec_matmul_fused(a, b, pol, residual=ep.residual, **kw)


def _dim_map(ia: str, ib: str, a_shape, b_shape) -> Dict[str, int]:
    dims: Dict[str, int] = {}
    for labels, shape, what in ((ia, a_shape, "lhs"), (ib, b_shape, "rhs")):
        if len(labels) != len(shape):
            raise ValueError(
                f"operand rank mismatch: {what} labels {labels!r} vs shape "
                f"{tuple(shape)}")
        for c, s in zip(labels, shape):
            if dims.setdefault(c, s) != s:
                raise ValueError(
                    f"size mismatch for label {c!r}: {dims[c]} vs {s}")
    return dims


def einsum(eq: str, a, b, *, site: Optional[str] = None,
           policy: TcecPolicy | str | None = None,
           epilogue: Optional[Epilogue] = None,
           precision: str = "native") -> torch.Tensor:
    """Policy-aware two-operand einsum (fp32 accumulate).

    ``a``/``b`` are tensors or ``FragmentOperand`` rules; ``policy`` is a
    registered name, a ``TcecPolicy``, or ``None`` (resolve from the active
    ``policy_scope`` for ``site``); ``epilogue`` fuses
    scale/bias/activation/residual/output-cast into the store.  See the
    module docstring for ``precision``.  Returns fp32 unless
    ``epilogue.out_dtype`` says otherwise.
    """
    if precision not in ("native", "strict"):
        raise ValueError(f"precision must be 'native' or 'strict', "
                         f"got {precision!r}")
    pol = resolve_policy(policy, site)
    ia, ib, out = parse_equation(eq)
    ep = epilogue if epilogue is not None else NO_EPILOGUE
    a_frag = isinstance(a, FragmentOperand)
    b_frag = isinstance(b, FragmentOperand)
    dims = _dim_map(ia, ib, a.shape, b.shape)
    out_shape = tuple(dims[c] for c in out)
    if ep.residual is not None and tuple(ep.residual.shape) != out_shape:
        raise ValueError(
            f"epilogue residual shape {tuple(ep.residual.shape)} != output "
            f"shape {out_shape} for {eq!r}")
    # The kernel reads an (n,) bias per output column; other broadcast
    # shapes take the twin.
    bias_ok = ep.bias is None or tuple(ep.bias.shape) == (out_shape[-1],)
    plan = plan_einsum(
        ia, ib, out, pol, bias_ok, a_frag, b_frag, len(b.shape),
        b_frag_in_kernel_ok=not (b_frag and b.closes_over_arrays()),
        b_frag_on_menu=b_frag and b.menu is not None)
    log = _TRACE.get()
    if log is not None:
        log.append(PlanRecord(f"{ia},{ib}->{out}", site, pol, plan.backend))
    if a_frag:
        a = a.build()
    if plan.backend == "pallas_fragment":
        return _run_kernel(plan.pattern, pol, a, None, ep, frag=b)
    if b_frag:
        b = b.build()
    if plan.backend == "pallas":
        return _run_kernel(plan.pattern, pol, a, b, ep)
    return ep.apply(_contract(f"{ia},{ib}->{out}", a, b, pol, precision))


def _matmul_equation(a_ndim: int, b_ndim: int) -> str:
    """(..., m, k) @ (k, n) | batched — the ``tc_matmul`` shape family."""
    letters = string.ascii_lowercase
    if a_ndim < 2 or b_ndim < 2:
        raise ValueError(f"matmul needs >=2-D operands, got ranks "
                         f"{a_ndim} and {b_ndim}")
    if b_ndim == 2:
        lead = letters[:a_ndim - 1]
        return f"{lead}y,yz->{lead}z"
    if b_ndim > a_ndim:
        raise ValueError(
            f"rhs rank {b_ndim} > lhs rank {a_ndim} is not supported")
    nb = b_ndim - 2
    batch = letters[:nb]
    mid = letters[nb:a_ndim - 1]
    return f"{batch}{mid}y,{batch}yz->{batch}{mid}z"


def matmul(a: torch.Tensor, b: torch.Tensor, *, site: Optional[str] = None,
           policy: TcecPolicy | str | None = None,
           epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """``a @ b`` through the frontend (equation derived from the ranks)."""
    return einsum(_matmul_equation(a.dim(), b.dim()), a, b, site=site,
                  policy=policy, epilogue=epilogue)
