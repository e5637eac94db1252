"""hpfrec_tpu_torch — Hierarchical Poisson Factorization on PyTorch and CUDA.

The port of ``hpfrec_tpu`` to an NVIDIA H100: the same ``HPF`` class,
with full-batch CAVI, mini-batch SVI, batch serving and online updates on
hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions on
the CPU.
"""

from .models.hpf import HPF

__all__ = ["HPF"]
__version__ = "0.1.0"
