"""Model assembly: embeddings -> blocks -> norm -> tied LM head.

Counterpart of ``repro.models.model`` for the dense GQA decoder: ``Model``
holds the parameters (``embed``, ``blocks[i]`` with ``norm1``/``mixer``/
``norm2``/``ffn``, ``final_norm``) under the reference's names; the layer
stack is a ``ModuleList`` (the reference scans group-stacked leaves).
``prefill`` and ``decode_step_paged`` install the config's
``site_policies()`` as context defaults, below any active ``policy_scope``.
"""
from __future__ import annotations

import string
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import tcec
from repro_torch.configs.base import ArchConfig
from repro_torch.core.context import policy_defaults, resolve
from .base import init_param_, resolve_device, rms_norm
from .blocks import Block, block_apply


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        if cfg.encoder_layers or cfg.vision_tokens:
            raise NotImplementedError(
                "encoder/vision front ends are not ported yet")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied LM heads are not ported yet (qwen2 ties)")
        dtype = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab, cfg.d_model), dtype=dtype, device=device),
            requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.pattern[i % cfg.group_len], dtype, device)
            for i in range(cfg.n_layers))
        self.final_norm = nn.Parameter(
            torch.empty(cfg.d_model, dtype=dtype, device=device),
            requires_grad=False)


_ZERO_INIT = ("bq", "bk", "bv", "norm1", "norm2", "final_norm")


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Model:
    """A model with parameters drawn as the reference's ``init_params``
    draws them (biases and norm scales zero; weights normal at
    1/sqrt(fan_in)), from ``generator`` (a fresh seed-0 generator on
    ``device`` when None).  The two frameworks' random streams differ;
    use ``convert.params_from_jax`` for identical weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    model = Model(cfg, dev)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        init_param_(p, generator, "zeros" if leaf in _ZERO_INIT else "normal")
    return model


def _embed_tokens(params: Model, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    e = params.embed[tokens]
    return (e.float() * (cfg.d_model ** 0.5)).to(e.dtype)


def _run_blocks(params: Model, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, caches: Optional[Dict] = None,
                emit_cache: bool = False, block_table=None, seq_lens=None):
    """Every layer in order.  Prefill (``emit_cache``) returns the stacked
    ``{"k", "v"}`` (L, b, s, kvh, hd); a paged step appends to the
    ``(L, P, page, kvh, hd)`` pools in place and returns them."""
    ks, vs = [], []
    for i, blk in enumerate(params.blocks):
        layer_cache = None
        if caches is not None:
            layer_cache = {key: val[i] for key, val in caches.items()}
        x, nc = block_apply(blk, x, cfg, positions, cache=layer_cache,
                            emit_cache=emit_cache, block_table=block_table,
                            seq_lens=seq_lens)
        if emit_cache:
            ks.append(nc["k"])
            vs.append(nc["v"])
    if emit_cache:
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, caches


def backbone(params: Model, batch: Dict, cfg: ArchConfig, *,
             emit_cache: bool = False):
    """Token embeddings -> final hidden states.  Returns (hidden, caches)."""
    with policy_defaults(cfg.site_policies()):
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed_tokens(params, tokens, cfg)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
        x, caches = _run_blocks(params, x, cfg, positions,
                                emit_cache=emit_cache)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, caches


def _logits(params: Model, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Tied head ``h (..., d)`` against the (v, d) embedding.  The equation
    is not matmul-shaped, so it runs the twin under every policy (the
    reference runs it on its XLA split path the same way)."""
    w = params.embed
    pol = tcec.wide_weight_policy(resolve("lm_head"), w.dtype)
    lead = string.ascii_lowercase[:h.dim() - 1]
    return tcec.einsum(f"{lead}y,zy->{lead}z", h, w, site="lm_head",
                       policy=pol)


def prefill(params: Model, batch: Dict, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt, emitting caches.  Returns (last-position
    logits (b, v) fp32, caches)."""
    h, caches = backbone(params, batch, cfg, emit_cache=True)
    with policy_defaults(cfg.site_policies()):
        logits = _logits(params, h[:, -1:], cfg)[:, 0]
    return logits, caches


def decode_step_paged(params: Model, tokens: torch.Tensor, caches: Dict,
                      block_table: torch.Tensor, seq_lens: torch.Tensor,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One continuous-batching decode step against paged caches.

    ``tokens (b, 1)``; ``block_table (b, npages)``; ``seq_lens (b,)`` is each
    slot's cache length (the new token is appended there, rope positions
    follow it).  Attention caches are positional and overwrite-idempotent,
    so idle lanes need no mask (the reference's ``active`` mask serves
    recurrent mixers, which are not ported).  The pools are updated in
    place.  Returns (last-position logits (b, v), caches).
    """
    s = tokens.shape[1]
    with policy_defaults(cfg.site_policies()):
        x = _embed_tokens(params, tokens, cfg)
        positions = seq_lens[:, None].to(torch.int32) \
            + torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
        x, caches = _run_blocks(params, x, cfg, positions, caches=caches,
                                block_table=block_table, seq_lens=seq_lens)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = _logits(params, x[:, -1:], cfg)[:, 0]
    return logits, caches


def init_paged_decode_caches(cfg: ArchConfig, slots: int, num_pages: int,
                             page_size: int, device="cuda") -> Dict:
    """Zero page pools ``{"k_pages", "v_pages"}``, each
    (n_layers, num_pages, page_size, kvh, hd) at the parameter dtype."""
    from repro_torch.serving.paged_cache import init_pool
    del slots  # attention-only models keep no per-slot state
    dev = resolve_device(device)
    tail = (cfg.n_kv_heads, cfg.head_dim_)
    dtype = getattr(torch, cfg.param_dtype)
    return {key: init_pool(num_pages, page_size, tail, dtype, dev,
                           layers=cfg.n_layers)
            for key in ("k_pages", "v_pages")}
