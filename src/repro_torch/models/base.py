"""Primitive layers and parameter initialisation (counterpart of
``repro.models.base``, forward only).

Dense layers route every matmul through the policy-aware einsum frontend
(``repro_torch.tcec``): each ``dense`` call carries a *site* tag and its
policy is resolved from the active ``repro_torch.core.context`` scope.
"""
from __future__ import annotations

import string
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import tcec
from repro_torch.core.context import resolve_policy
from repro_torch.core.policy import TcecPolicy


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) requires a card: without one this raises instead of
    quietly running on the CPU — pass ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain versions on the CPU")
    return dev


def init_param_(p: torch.Tensor, generator: torch.Generator,
                init: str = "normal", init_scale: float = 1.0) -> None:
    """Fill one parameter in place, as ``repro.models.base.initialize``:
    zeros, ones, or a normal draw at ``init_scale / sqrt(fan_in)`` made in
    fp32 and cast to the parameter's dtype.  ``shape[-2]`` is the fan-in of
    an (in, out) weight."""
    with torch.no_grad():
        if init == "zeros":
            p.zero_()
        elif init == "ones":
            p.fill_(1.0)
        else:
            shape = p.shape
            fan_in = shape[-2] if len(shape) > 1 else max(shape[-1], 1)
            std = init_scale / (fan_in ** 0.5)
            draw = torch.randn(shape, generator=generator, device=p.device,
                               dtype=torch.float32)
            p.copy_((draw * std).to(p.dtype))


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor, site: Optional[str] = None,
          bias: Optional[torch.Tensor] = None, *,
          policy=None, activation: Optional[str] = None) -> torch.Tensor:
    """x (..., d) @ w (d, f) through the einsum frontend.

    The bias add, optional ``activation`` and the output cast ride the
    fused epilogue.  Output dtype follows x for uncorrected policies, fp32
    for corrected ones.
    """
    pol: TcecPolicy = resolve_policy(policy, site)
    plain = pol.backend == "mxu" and not pol.error_correction
    # Wide (fp32) weights are never silently rounded by an uncorrected
    # twin policy.
    exec_pol = tcec.wide_weight_policy(pol, w.dtype)
    lead = string.ascii_lowercase[:x.dim() - 1]
    ep = None
    if bias is not None or activation is not None or plain:
        ep = tcec.Epilogue(bias=bias, activation=activation,
                           out_dtype=x.dtype if plain else None)
    return tcec.einsum(f"{lead}y,yz->{lead}z", x, w, site=site,
                       policy=exec_pol, epilogue=ep)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, statistics in fp32, ``y * (1 + scale)`` cast back to x's
    dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": tcec.ACTIVATIONS["gelu"],
            "relu": F.relu}[name]


def largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (chunk-size selection)."""
    target = min(n, target)
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return 1


# ---------------------------------------------------------------------------
# Rotary embeddings (rotate-half convention)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (b, s) -> cos/sin (b, s, head_dim/2), fp32."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), expo)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d) with cos/sin (b, s, d/2); the rotation runs in x's
    dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
