"""Architecture configs of the port (counterpart of ``repro.configs``)."""
from .base import ARCH_IDS, ArchConfig, BlockSpec, get_config

__all__ = ["ARCH_IDS", "ArchConfig", "BlockSpec", "get_config"]
