"""``repro_torch.tune`` — roofline-driven tile and variant choice for the
TCEC matmul (counterpart of ``repro.tune``, ``matmul_plan`` only).

``matmul_plan`` ranks (tile, variant) candidates with the analytic model of
``repro_torch.core.roofline`` and, under ``REPRO_TUNE=measure``, times the
top ones on the card and persists the winner under ``~/.cache/repro-tune/``
(``REPRO_TUNE_CACHE`` relocates it).  ``REPRO_TUNE=off`` returns ``None``:
callers use the default tile.
"""
from .cache import (SCHEMA_VERSION, cache_dir, clear_plan_cache,  # noqa: F401
                    plan_cache)
from .space import (MatmulCandidate, matmul_candidates,  # noqa: F401
                    matmul_variants)
from .tuner import (MODES, MatmulPlan, matmul_plan, mode,  # noqa: F401
                    tune_mode)

__all__ = [
    "MatmulPlan", "matmul_plan", "matmul_candidates", "matmul_variants",
    "MatmulCandidate", "mode", "tune_mode", "MODES",
    "cache_dir", "clear_plan_cache", "plan_cache", "SCHEMA_VERSION",
]
