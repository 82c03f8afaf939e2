"""birdnet_stm32_tpu_torch: the PyTorch/CUDA port of birdnet_stm32_tpu.

The JAX package `birdnet_stm32_tpu` is the reference; this package mirrors
its module paths and names so each counterpart is easy to find, and returns
the same results on the same inputs (tests/test_torch_*.py hold it to that).
It imports torch and numpy, never jax, flax or the JAX package.

Ported so far: the float32 serving path — fused waveform -> |STFT| frontend
(a hand-written CUDA kernel for Hopper, ops/csrc/frontend_kernel.cu) and
the DS-CNN classifier — behind models/serving.py::make_fused_classifier.
Public functions keep the JAX layouts: features [B, bins, W, 1], scores
[B, C]. Entry points take `device=` and default to "cuda".
"""

from birdnet_stm32_tpu_torch.version import __version__

__all__ = ["__version__"]
