"""Transformer block: (norm -> attention -> +res) -> (norm -> ffn -> +res).

Counterpart of ``repro.models.blocks`` for ``BlockSpec("attn", "dense")``,
the block of the dense GQA decoders; other block kinds are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, BlockSpec
from .attention import Attention, gqa_apply
from .base import dense, rms_norm


class FFN(nn.Module):
    """Gated FFN weights under the reference's parameter names."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)
        self.w_gate = param(d, ff)
        self.w_up = param(d, ff)
        self.w_down = param(ff, d)


class Block(nn.Module):
    """``norm1`` -> ``mixer`` (GQA) -> ``norm2`` -> ``ffn``."""

    def __init__(self, cfg: ArchConfig, spec: BlockSpec, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        if (spec.mixer, spec.ffn) != ("attn", "dense"):
            raise NotImplementedError(
                f"block kind {spec} is not ported yet (only attn + dense)")
        d = cfg.d_model
        self.norm1 = nn.Parameter(torch.empty(d, dtype=dtype, device=device),
                                  requires_grad=False)
        self.mixer = Attention(cfg, dtype, device)
        self.norm2 = nn.Parameter(torch.empty(d, dtype=dtype, device=device),
                                  requires_grad=False)
        self.ffn = FFN(cfg, dtype, device)


def ffn_apply(p: FFN, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The gate activation rides the gate matmul's fused epilogue."""
    gated = dense(x, p.w_gate, "ffn", activation=cfg.act)
    h = gated * dense(x, p.w_up, "ffn")
    return dense(h.to(x.dtype), p.w_down, "ffn").to(x.dtype)


def block_apply(p: Block, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                causal: bool = True, emit_cache: bool = False,
                block_table=None, seq_lens=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    y, new_cache = gqa_apply(p.mixer, h, cfg, positions, cache=cache,
                             causal=causal, emit_kv=emit_cache,
                             block_table=block_table, seq_lens=seq_lens)
    x = x + y
    h = rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + ffn_apply(p.ffn, h, cfg)
    return x, new_cache
