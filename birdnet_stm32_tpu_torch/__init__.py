"""birdnet_stm32_tpu_torch: the PyTorch/CUDA port of birdnet_stm32_tpu.

The JAX package `birdnet_stm32_tpu` is the reference; this package mirrors
its module paths and names so each counterpart is easy to find, and returns
the same results on the same inputs (tests/test_torch_*.py hold it to that).
It imports torch and numpy, never jax, flax or the JAX package.

Ported: every verb of the JAX package (serve, train, evaluate, benchmark,
board-test, profile, convert, deploy) and every module behind them: the
.keras transplant (models/transplant.py), the portable serving module as a
torch.export program (conversion/export_program.py), the native WAV reader,
resampler and libav codec (audio/native.py) and data-parallel training
over torch.distributed (parallel/distributed.py, parallel/mesh.py). The
fused waveform -> |STFT| frontend runs as hand-written CUDA kernels for
Hopper (ops/csrc/frontend_kernel.cu); the INT8 leg is the port's own
bit-exact integer executor (quant/tflite_import.py). ROADMAP.md lists the
one part left: serving over several local devices.

Public functions keep the JAX layouts: features [B, bins, W, 1], scores
[B, C]. Entry points take `device=` and default to "cuda".
"""

from birdnet_stm32_tpu_torch.version import __version__

__all__ = ["__version__"]
