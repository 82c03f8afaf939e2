"""Device selection and float32 precision for the port's entry points.

Entry points take `device=` and default to "cuda". A CUDA device on a
machine without one raises: nothing falls back to the CPU silently.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`, raising if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    # "cuda" and "cuda:<current>" name one device: compare equal afterwards.
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def full_fp32():
    """Run float32 matmuls and cuDNN convolutions in full float32, and
    accumulate bf16 matmuls in full float32.

    cuDNN convolutions default to TF32 on Ampere and later (about three
    decimal digits), which is far outside the port's parity gates against
    the JAX reference's HIGHEST-precision forward. Matmul TF32 is off by
    default, but a caller may have turned it on, so both are pinned here.
    cuBLAS may also reduce bf16 GEMMs in reduced precision
    (allow_bf16_reduced_precision_reduction, on by default); the bf16
    forward's mel mixer is a HIGHEST-precision matmul over bf16 operands in
    the JAX package (f32 accumulation, one rounding), so that is pinned
    off too.
    """
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = prev
