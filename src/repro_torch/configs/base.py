"""Architecture configuration schema + registry (counterpart of
``repro.configs.base``).

One ``ArchConfig`` describes an architecture; the layer stack is a repeating
*pattern group* of ``BlockSpec``s (mixer kind + ffn kind).  The port runs the
dense GQA decoder, pattern ``(BlockSpec("attn", "dense"),)``; its model raises
``NotImplementedError`` on the other kinds.
"""
from __future__ import annotations

import dataclasses
import importlib
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"
    ffn: str = "dense"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # Sub-configs of the architectures the port does not run yet (MoE, MLA,
    # SSM, xLSTM); kept so the field set matches the reference's.
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[Any] = None
    xlstm: Optional[Any] = None
    # Encoder-decoder (whisper): encoder layer count + fixed source length.
    encoder_layers: int = 0
    encoder_len: int = 0          # stubbed frame/patch embeddings length
    # VLM: number of stub vision-patch embeddings prepended to the text.
    vision_tokens: int = 0
    # Precision / paper-technique policy.
    param_dtype: str = "bfloat16"
    # DEPRECATED string-threaded policy fields — still honored (mapped into
    # the site-defaults tier by site_policies()) but superseded by
    # ``policy_overrides``.  Scheduled for removal; new code should use
    # ``policy_overrides`` or wrap runs in ``repro_torch.core.policy_scope``.
    matmul_policy: str = "bf16x1"     # bulk dense layers
    logits_policy: str = "bf16x3"     # LM head (TCEC fp32-accurate)
    # Site -> policy-name defaults consumed by repro_torch.core.context.  Keys are
    # site tags ("lm_head", "router", "attn", ...) plus "default" for the
    # bulk policy.  Any active policy_scope overrides these.  A Mapping is
    # accepted at construction and normalized to a sorted tuple of pairs in
    # __post_init__ so the frozen config stays hashable.
    policy_overrides: Tuple[Tuple[str, str], ...] = ()
    remat: str = "full"               # full | dots | none
    sub_quadratic: bool = False       # supports long_500k decode

    def __post_init__(self):
        ov = self.policy_overrides
        if isinstance(ov, Mapping):
            ov = ov.items()
        object.__setattr__(self, "policy_overrides",
                           tuple(sorted((str(k), v) for k, v in ov)))

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_len(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_len == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by pattern {self.group_len}"
        return self.n_layers // self.group_len

    def site_policies(self) -> Dict[str, str]:
        """Site->policy defaults for ``repro_torch.core.context.policy_defaults``.

        Merges the deprecated string-threaded fields (``matmul_policy`` ->
        the bulk "default", ``logits_policy`` -> "lm_head",
        ``moe.router_policy`` -> "router") under ``policy_overrides``, which
        always wins.  Deviating from a legacy field's default without a
        matching ``policy_overrides`` entry emits a DeprecationWarning."""
        legacy = {"default": ("matmul_policy", self.matmul_policy, "bf16x1"),
                  "lm_head": ("logits_policy", self.logits_policy, "bf16x3")}
        if self.moe is not None:
            legacy["router"] = ("moe.router_policy",
                                self.moe.router_policy, "bf16x3")
        overrides = dict(self.policy_overrides)
        out: Dict[str, str] = {}
        for site, (field_name, value, default) in legacy.items():
            if value != default and site not in overrides:
                warnings.warn(
                    f"{self.name}: config field {field_name!r} is deprecated; "
                    f"use policy_overrides={{{site!r}: {value!r}}} or wrap the "
                    f"run in repro_torch.core.policy_scope",
                    DeprecationWarning, stacklevel=2)
            out[site] = value
        out.update(overrides)
        return out

    def validate(self) -> None:
        _ = self.n_groups
        from repro_torch.core.policy import get_policy
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            for site, pol in self.site_policies().items():
                get_policy(pol)   # fail fast on unknown policy names
        if any(b.ffn == "moe" for b in self.pattern):
            assert self.moe is not None, f"{self.name}: moe pattern without MoeConfig"
        if any(b.mixer == "mla" for b in self.pattern):
            assert self.mla is not None
        if any(b.mixer == "mamba" for b in self.pattern):
            assert self.ssm is not None
        if any(b.mixer in ("mlstm", "slstm") for b in self.pattern):
            assert self.xlstm is not None


# ---------------------------------------------------------------------------
# Registry (the architectures the port runs)
# ---------------------------------------------------------------------------
_ARCH_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    """Load an architecture config by id (``--arch`` flag values)."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    cfg = mod.reduced_config() if reduced else mod.config()
    cfg.validate()
    return cfg
