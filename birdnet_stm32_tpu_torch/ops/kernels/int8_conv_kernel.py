"""The INT8 executor's integer convolutions as hand-written CUDA kernels
(ops/csrc/int8_conv_kernel.cu), with the TFLite requantization, and a
following residual ADD, fused into the epilogue.

They replace no Pallas kernel: the JAX package leaves these convolutions to
XLA. On a CUDA device `quant/tflite_import.py::build_executor` computes
with them what its plain steps compute (`_tap_conv`, the GEMM of int8
codes, `_requant_fn`, `_op_add_sub`), bit for bit:

- `taps_conv` (`int8_conv_taps_kernel`): DEPTHWISE_CONV_2D with any
  kernel size, stride, dilation and depth multiplier, and CONV_2D over one
  input channel;
- `pointwise_conv` (`int8_conv_pointwise_kernel`): 1x1 CONV_2D with any
  stride and at most `MAX_POINTWISE_IN` input channels, optionally with
  the residual ADD that follows it (`AddEpilogue`).

The executor uploads each convolution's constants once (`taps_weights`,
`pointwise_weights`, `epilogue`); the launchers take the tensors of one
call, check them, allocate the output with `torch.empty` and launch on the
tensor's card, on the current stream (so a CUDA graph captures them), or
raise. They take CUDA tensors only: the plain versions, which the CPU runs
and the tests hold these against, stay in `quant/tflite_import.py`. The
library is built with nvcc (`_build.py`) on the first call of `library()`,
which the executor makes when it builds on a card. Launches are counted in
`launches` by kernel name.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

TAPS_KERNEL = "int8_conv_taps_kernel"
POINTWISE_KERNEL = "int8_conv_pointwise_kernel"
# The pointwise kernel keeps a block's [C_in rounded up to 16, 64] weight
# slice in shared memory: 16 KB at most.
MAX_POINTWISE_IN = 256
_POINTWISE_TN = 64
# Kernel launches since the last clear(), by kernel name.
launches: collections.Counter[str] = collections.Counter()
# ops/csrc/int8_conv_kernel.cu's TapsRead.
_READ_VECTOR, _READ_ONE, _READ_GATHER = 0, 1, 2


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernels' library, built with nvcc on the first call."""
    from birdnet_stm32_tpu_torch.ops.kernels import _build

    lib = _build.load("int8_conv_kernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_conv_taps.argtypes = [p] * 12 + [i] * 3 + [p]
    lib.int8_conv_pointwise.argtypes = [p] * 14 + [i] * 2 + [p]
    lib.int8_conv_taps.restype = lib.int8_conv_pointwise.restype = i
    return lib


@dataclass(frozen=True)
class Epilogue:
    """One convolution's requantization on the card, per output channel:
    the int64 correction (bias - zi * sum w, plus a folded constant
    concat's term), the fixed-point multiplier and shift (requant "exact")
    and the float32 multiplier ("fast"); then the output zero point and the
    fused activation's bounds."""

    correction: torch.Tensor
    qm: torch.Tensor
    shift: torch.Tensor
    mult: torch.Tensor
    zp: int
    lo: int
    hi: int
    fast: bool


def epilogue(correction, qm, shift, mult, zp: int, lo: int, hi: int, fast: bool,
             channels: int, device: torch.device) -> Epilogue:
    """Upload a convolution's requantization; each per-channel argument is
    one value or `channels` values."""
    def per_channel(v, dtype):
        v = np.broadcast_to(np.asarray(v, dtype).reshape(-1), (channels,)).copy()
        return torch.from_numpy(v).to(device)
    return Epilogue(per_channel(correction, np.int64), per_channel(qm, np.int32),
                    per_channel(shift, np.int32), per_channel(mult, np.float32),
                    int(zp), int(lo), int(hi), bool(fast))


@dataclass(frozen=True)
class AddEpilogue:
    """The TFLite int8 ADD after a 1x1 convolution, as `_op_add_sub`
    computes it: the residual's and the convolution's zero point and MBQM
    (multiplier, shift) to twice the larger input scale at 20 fractional
    bits, the output's MBQM, zero point and activation bounds; the fields
    in the order of int8_conv_kernel.cu's AddEpilogue."""

    z_res: int
    qm_res: int
    shift_res: int
    z_conv: int
    qm_conv: int
    shift_conv: int
    qm_out: int
    shift_out: int
    zp: int
    lo: int
    hi: int


@dataclass(frozen=True)
class TapWeights:
    """A taps convolution's weights on the card: int8 [kh * kw, C_out],
    tap (p, q) at row p * kw + q."""

    taps: torch.Tensor
    kh: int
    kw: int


def taps_weights(w_taps: np.ndarray, device: torch.device) -> TapWeights:
    """Upload [kh, kw, C_out] int8 tap weights."""
    kh, kw, c = w_taps.shape
    taps = np.ascontiguousarray(w_taps.reshape(kh * kw, c).astype(np.int8))
    return TapWeights(torch.from_numpy(taps).to(device), kh, kw)


@dataclass(frozen=True)
class PointwiseWeights:
    """A 1x1 convolution's weights on the card as the pointwise kernel
    reads them: int32 words [k_words, npad], word (k, n) the int8 weights
    of output channel n at input channels 4k .. 4k + 3 (little-endian,
    zero past C_in and C_out); a block takes `tn` output channels."""

    words: torch.Tensor
    in_channels: int
    channels: int
    tn: int


def pointwise_weights(w: np.ndarray, device: torch.device) -> PointwiseWeights:
    """Upload [C_out, C_in] int8 weights, C_in <= MAX_POINTWISE_IN."""
    c_out, c_in = w.shape
    if not 0 < c_in <= MAX_POINTWISE_IN:
        raise ValueError(f"int8 pointwise convolution takes 1..{MAX_POINTWISE_IN} input "
                         f"channels, got {c_in}")
    tn = min(_POINTWISE_TN, 1 << max(3, (c_out - 1).bit_length()))
    npad = -(-c_out // tn) * tn
    kp = -(-c_in // 16) * 16
    padded = np.zeros((npad, kp), np.int8)
    padded[:c_out, :c_in] = w
    words = np.ascontiguousarray(padded.view("<i4").T)  # [kp / 4, npad]
    return PointwiseWeights(torch.from_numpy(words).to(device), c_in, c_out, tn)


def _check_codes(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda or x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"{what} takes a CUDA int8 [B, H, W, C] tensor, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def _aligned(x: torch.Tensor, strides, n: int) -> bool:
    """Whether every `n`-byte vector the kernel would load from x lies on an
    n-byte boundary."""
    return x.data_ptr() % n == 0 and all(s % n == 0 for s in strides)


def _largest_vector(channels: int) -> int:
    return next(v for v in (16, 8, 4, 1) if channels % v == 0)


def _ptrs(*tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


def _ints(ctype, values):
    return (ctype * len(values))(*values)


def _run(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


def _rq_args(ep: Epilogue) -> list:
    return [*_ptrs(ep.correction, ep.qm, ep.shift, ep.mult), _ints(ctypes.c_int,
                                                                   (ep.zp, ep.lo, ep.hi))]


def taps_conv(x: torch.Tensor, weights: TapWeights, ep: Epilogue, *, out_hw: tuple[int, int],
              strides: tuple[int, int], dilation: tuple[int, int], pads: tuple[int, int],
              repeat: int, zi: int) -> torch.Tensor:
    """int8 [B, Ho, Wo, C_out] codes of a DEPTHWISE_CONV_2D (output channel
    c reads input channel c // repeat) or a one-input-channel CONV_2D
    (repeat = C_out) over the int8 NHWC input x, read through its strides;
    taps outside x read the zero point zi, `pads` is (top, left)."""
    _check_codes(x, "int8 taps convolution")
    B, H, W, c_in = x.shape
    c_out = weights.taps.shape[1]
    if c_in * repeat != c_out or weights.taps.device != x.device:
        raise ValueError(f"int8 taps convolution: {c_in} input channels x {repeat} != "
                         f"{c_out} weight channels, or weights on {weights.taps.device}")
    Ho, Wo = out_hw
    out = torch.empty((B, Ho, Wo, c_out), dtype=torch.int8, device=x.device)
    cv = _largest_vector(c_out)
    xs, os = list(x.stride()), list(out.stride())[:3]
    if c_in == 1:
        read = _READ_ONE
    elif repeat == 1 and xs[3] == 1 and _aligned(x, xs[:3], cv):
        read = _READ_VECTOR
    else:
        read = _READ_GATHER
    (kh, kw), (sh, sw), (dh, dw), (pt, pl) = (weights.kh, weights.kw), strides, dilation, pads
    tap_h, tap_w = kw, 1
    if xs[1] < xs[2]:
        # The input's rows are its contiguous axis (a transposed view): run
        # the transposed problem, whose neighbouring threads then read
        # neighbouring bytes, and write the output through its strides.
        xs[1], xs[2], os[1], os[2] = xs[2], xs[1], os[2], os[1]
        H, W, Ho, Wo, kh, kw, sh, sw, dh, dw, pt, pl = W, H, Wo, Ho, kw, kh, sw, sh, dw, dh, pl, pt
        tap_h, tap_w = tap_w, tap_h
    _run(library().int8_conv_taps, TAPS_KERNEL, x.device, *_ptrs(x),
         _ints(ctypes.c_longlong, xs), *_ptrs(weights.taps, out), _ints(ctypes.c_longlong, os),
         _ints(ctypes.c_int, (B, H, W, Ho, Wo, c_out)),
         _ints(ctypes.c_int, (kh, kw, sh, sw, dh, dw, pt, pl, repeat, zi, tap_h, tap_w)),
         *_rq_args(ep), cv, read, int(ep.fast))
    return out


def pointwise_conv(x: torch.Tensor, weights: PointwiseWeights, ep: Epilogue, *,
                   strides: tuple[int, int], residual: torch.Tensor | None = None,
                   add: AddEpilogue | None = None, keep_conv: bool = False):
    """int8 [B, Ho, Wo, C_out] codes of a 1x1 CONV_2D over the int8 NHWC
    input x (Ho = ceil(H / stride)); with `add` and the [B, Ho, Wo, C_out]
    int8 `residual`, the codes of the ADD of the convolution's codes and
    the residual, and with keep_conv also the convolution's own codes, as
    (add codes, conv codes). A channel-strided x or residual is copied to a
    contiguous one first."""
    _check_codes(x, "int8 pointwise convolution")
    if x.stride(3) != 1:
        x = x.contiguous()
    B, H, W, c_in = x.shape
    if c_in != weights.in_channels or weights.words.device != x.device:
        raise ValueError(f"int8 pointwise convolution: {c_in} input channels, weights for "
                         f"{weights.in_channels} on {weights.words.device}")
    (sh, sw), c_out = strides, weights.channels
    Ho, Wo = -(-H // sh), -(-W // sw)
    shape = (B, Ho, Wo, c_out)
    if (add is None) != (residual is None):
        raise ValueError("int8 pointwise convolution: give the residual with its ADD")
    if residual is not None:
        _check_codes(residual, "int8 pointwise convolution's residual")
        if tuple(residual.shape) != shape or residual.device != x.device:
            raise ValueError(f"int8 pointwise convolution's residual {tuple(residual.shape)} "
                             f"on {residual.device}, want {shape} on {x.device}")
        residual = residual.contiguous()
    out = torch.empty(shape, dtype=torch.int8, device=x.device)
    conv_out = torch.empty_like(out) if keep_conv else None
    xs = (x.stride(0), x.stride(1) * sh, x.stride(2) * sw)
    vec = next(v for v in (16, 4, 1) if c_in % v == 0 and _aligned(x, xs, v))
    words = weights.words
    add_args = None if add is None else _ints(ctypes.c_int, dataclasses.astuple(add))
    _run(library().int8_conv_pointwise, POINTWISE_KERNEL, x.device, *_ptrs(x),
         _ints(ctypes.c_longlong, xs), *_ptrs(words),
         _ints(ctypes.c_int, (words.shape[0], words.shape[1], weights.tn)),
         *_ptrs(out, conv_out, residual), _ints(ctypes.c_int, (B, Ho, Wo, c_in, c_out)),
         *_rq_args(ep), add_args, vec, int(ep.fast))
    return (out, conv_out) if keep_conv else out
