"""ursonet_torch: the PyTorch/CUDA port of ursonet_tpu, for one NVIDIA H100.

The JAX package `ursonet_tpu` stays the reference; this package imports
none of it. Entry points take `device` (default 'cuda'); the CPU runs
the plain PyTorch versions of the kernels, and only when asked for.
"""

from ursonet_torch.config import Config

__all__ = ["Config"]
