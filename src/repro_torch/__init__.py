"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports neither
JAX nor anything of ``repro``.  Every Pallas kernel on the ported path is a
CUDA C++ kernel for ``sm_90a`` (``repro_torch/csrc``), built with nvcc at
first use and bound with ctypes; each has a plain PyTorch version that CPU
tensors run.  Entry points default to ``device="cuda"`` and raise without a
card unless ``device="cpu"`` is passed.
"""
__version__ = "0.1.0"
