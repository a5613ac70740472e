"""qwen2-0.5b [dense] — 24L d896 14H (GQA kv=2) ff=4864 vocab=151936.
GQA with QKV bias, tied embeddings.  [arXiv:2407.10671; hf]"""
from .base import ArchConfig, BlockSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151936,
        pattern=(BlockSpec("attn", "dense"),),
        act="silu", qkv_bias=True, tie_embeddings=True,
        rope_theta=1000000.0,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        pattern=(BlockSpec("attn", "dense"),),
        act="silu", qkv_bias=True, tie_embeddings=True, remat="none",
    )
