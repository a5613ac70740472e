"""Weights carried across from the reference's parameter pytree.

``params_from_jax(np_tree, cfg, device)`` takes the JAX package's params as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's ``Model`` with the same values and dtypes.  The
reference stacks each pattern position's block leaves over a leading
``n_groups`` axis (``blocks/pos{i}/...``, scanned per group); layer
``g * len(pattern) + i`` is slice ``g`` of ``pos{i}``.  Parameter names are
otherwise identical, so the conversion is a name map.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from .base import resolve_device
from .model import Model

__all__ = ["params_from_jax", "to_torch"]


def to_torch(arr, device) -> torch.Tensor:
    """numpy -> torch on ``device``, keeping the dtype.  JAX's bf16 arrays
    are ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects; they
    cross as their uint16 bit pattern."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _assign(module: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    cur = getattr(module, name)
    if cur is None:
        raise KeyError(f"{type(module).__name__} has no parameter {name!r}")
    if tuple(cur.shape) != tuple(value.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                         f"{tuple(cur.shape)}")
    if cur.dtype != value.dtype:
        raise ValueError(f"{name}: dtype {value.dtype} != {cur.dtype}")
    with torch.no_grad():
        cur.copy_(value)


def params_from_jax(np_tree: Dict[str, Any], cfg: ArchConfig,
                    device="cuda") -> Model:
    """The port's model holding the reference pytree's weights."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    _assign(model, "embed", to_torch(np_tree["embed"], dev))
    _assign(model, "final_norm", to_torch(np_tree["final_norm"], dev))
    glen = cfg.group_len
    for layer, blk in enumerate(model.blocks):
        g, i = divmod(layer, glen)
        src = np_tree["blocks"][f"pos{i}"]
        for key in ("norm1", "norm2"):
            _assign(blk, key, to_torch(src[key][g], dev))
        for key, leaf in src["mixer"].items():
            _assign(blk.mixer, key, to_torch(leaf[g], dev))
        for key, leaf in src["ffn"].items():
            _assign(blk.ffn, key, to_torch(leaf[g], dev))
    return model
