"""Declarative epilogues — the ``store_with_operation`` analogue.

Counterpart of ``repro.tcec.epilogue``.  An ``Epilogue`` describes what
happens to the fp32 accumulator before it leaves the kernel:

    y = act(acc * scale + bias) (+ residual)  ->  out_dtype

The CUDA matmul kernel applies the chain at its store; the twin applies the
same ops right after the split contraction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["Epilogue", "ACTIVATIONS", "NO_EPILOGUE"]


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "relu": F.relu,
    "gelu": _gelu_tanh,
    "silu": F.silu,
    "tanh": torch.tanh,
}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Fused post-matmul chain: ``act(y * scale + bias) + residual``.

    scale      — static Python float multiplier on the accumulator.
    bias       — tensor broadcastable to the output (typically (n,)).
    activation — name in ``ACTIVATIONS`` (applied to the fp32 value).
    residual   — tensor of the output shape, added after the activation.
    out_dtype  — final store dtype (default: fp32, the accumulator's).
    """
    scale: float = 1.0
    bias: Optional[torch.Tensor] = None
    activation: Optional[str] = None
    residual: Optional[torch.Tensor] = None
    out_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown epilogue activation {self.activation!r}; "
                f"known: {sorted(ACTIVATIONS)}")
        if not isinstance(self.scale, (int, float)):
            raise TypeError(
                "Epilogue.scale must be a static Python number (use bias/"
                f"residual for tensor operands), got {type(self.scale).__name__}")

    def apply(self, y: torch.Tensor) -> torch.Tensor:
        """The chain on an fp32 accumulator (the twin's epilogue)."""
        if self.scale != 1.0:
            y = y * self.scale
        if self.bias is not None:
            y = y + self.bias.float()
        if self.activation is not None:
            y = ACTIVATIONS[self.activation](y)
        if self.residual is not None:
            y = y + self.residual.float()
        if self.out_dtype is not None:
            y = y.to(self.out_dtype)
        return y


NO_EPILOGUE = Epilogue()
