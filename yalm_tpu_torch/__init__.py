"""yalm_tpu_torch: the PyTorch/CUDA port of yalm_tpu for NVIDIA Hopper.

Plain PyTorch around hand-written CUDA kernels (`csrc/`, built with nvcc
for sm_90a at first use). Every kernel wrapper runs its plain PyTorch
version on CPU tensors and its kernel on CUDA tensors. The JAX package
`yalm_tpu` is the reference the port is tested against; the port imports
nothing from it.
"""

from .config import KV_SINKS, ModelConfig

__all__ = ["ModelConfig", "KV_SINKS"]
