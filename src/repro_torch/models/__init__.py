"""The port's model zoo (counterpart of ``repro.models``): the dense GQA
decoder, forward only."""
from .convert import params_from_jax
from .model import (Model, backbone, decode_step_paged, init_paged_decode_caches,
                    init_params, prefill)

__all__ = ["params_from_jax", "Model", "backbone", "decode_step_paged",
           "init_paged_decode_caches", "init_params", "prefill"]
