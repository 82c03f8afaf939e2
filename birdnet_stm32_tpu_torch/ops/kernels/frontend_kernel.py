"""Fused waveform -> normalized linear |STFT| frontend (port of
ops/pallas/frontend_kernel.py).

The TPU kernel `_kernel` (grid="sample") becomes a hand-written CUDA kernel
for Hopper, ops/csrc/frontend_kernel.cu, in the hybrid specialisation the
serving path runs: mode="linear", mag_scale="none", quant=None. Its source
note says what bounds it (float32 FMA: 2 * n_frames * n_fft * 2F FLOP per
sample) and how its design handles a sample larger than shared memory.

`fused_spectrogram` dispatches on the tensor's device and nothing else:

- CUDA tensor: launches the kernel (built with nvcc on first use), counts
  the launch in the module attribute `launches`, or raises;
- CPU tensor: runs `fused_spectrogram_plain`, the same function in plain
  PyTorch, which the CPU tests hold against the JAX kernel and which the
  chip smoke test holds the CUDA kernel against.

Not ported yet (ROADMAP.md, Queue 2): the mel / log_mel / mfcc / pwl / db
epilogues and the int8 entry epilogue of `_kernel` (K1), the batched
`_kernel_tile` grid (K2). Asking for them raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from birdnet_stm32_tpu_torch.ops.magnitude import normalize_minmax
from birdnet_stm32_tpu_torch.ops.spectrogram import spectrogram_batch
from birdnet_stm32_tpu_torch.ops.stft import dft_bases_tensor, stft_magnitude

# Kernel launches since the last reset; the plain (CPU) path never counts.
launches = 0

_NOT_PORTED = ("ROADMAP.md, Queue 2, K1: the mel/log_mel/mfcc/pwl/db and "
               "int8-entry epilogues of the fused frontend are not ported yet")


def _geometry(T: int, n_fft: int, spec_width: int, hop: int | None,
              n_frames: int | None) -> tuple[int, int]:
    if hop is None:
        hop = max(1, T // spec_width) if spec_width > 0 else n_fft // 2
    if 2 * hop < n_fft:
        raise ValueError(f"fused frontend requires 2*hop >= n_fft, got {hop=} {n_fft=}")
    if n_frames is None:
        n_frames_full = 1 + T // hop
        n_frames = n_frames_full if spec_width <= 0 else min(spec_width, n_frames_full)
    return hop, n_frames


def fused_spectrogram_plain(y: torch.Tensor, n_fft: int, hop: int,
                            n_frames: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, T] -> [B, F, n_frames].

    Centre-pads, frames row k ++ row k+1 of the [n_frames+1, hop] view,
    takes |frames @ windowed DFT bases| in float32 (ops/stft.py), then
    per-sample min-max. With 2*hop >= n_fft no frame reaches past
    (n_frames+1)*hop samples, so this equals the reference's pad-and-cut
    (n_fft//2 on the left, exactly (n_frames+1)*hop samples kept).
    """
    S = stft_magnitude(y, n_fft=n_fft, hop=hop, n_frames=n_frames)  # [B, W, F]
    return normalize_minmax(S, dim=(1, 2)).transpose(1, 2)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from birdnet_stm32_tpu_torch.ops.kernels import _build

    lib = _build.load("frontend_kernel")
    lib.frontend_linear_bin_pad.argtypes = [ctypes.c_int]
    lib.frontend_linear_bin_pad.restype = ctypes.c_int
    lib.frontend_linear_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.frontend_linear_tiles.restype = ctypes.c_int
    lib.frontend_linear_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.frontend_linear_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _kernel_bases(n_fft: int, f_pad: int, device: torch.device) -> torch.Tensor:
    """[2, n_fft, f_pad] windowed cos/sin bases, zero past F; built once
    per geometry and device."""
    nbin = n_fft // 2 + 1
    wcs = dft_bases_tensor(n_fft, device)
    bases = torch.zeros(2, n_fft, f_pad, dtype=torch.float32, device=device)
    bases[0, :, :nbin] = wcs[:, :nbin]
    bases[1, :, :nbin] = wcs[:, nbin:]
    return bases


# Per-sample arrival counters, one buffer per (device, stream): the kernel
# leaves them at zero when it ends, so they are zeroed only when allocated.
_arrival_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _arrival_counter(B: int, device: torch.device, stream: int) -> torch.Tensor:
    key = (device, stream)
    buf = _arrival_counters.get(key)
    if buf is None or buf.numel() < B:
        buf = torch.zeros(B, dtype=torch.int32, device=device)
        _arrival_counters[key] = buf
    return buf


def _launch(y: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    global launches
    if not y.is_contiguous():
        raise ValueError("fused_spectrogram kernel needs a contiguous [B, T] tensor")
    if n_fft % 32:
        raise ValueError(f"fused_spectrogram kernel needs n_fft % 32 == 0, got {n_fft}")
    B, T = y.shape
    if not 0 < B <= 65535:
        raise ValueError(f"fused_spectrogram kernel takes 1..65535 samples, got {B}")
    lib = _lib()
    bases = _kernel_bases(n_fft, lib.frontend_linear_bin_pad(n_fft), y.device)
    nbin = n_fft // 2 + 1
    out = torch.empty(B, nbin, n_frames, dtype=torch.float32, device=y.device)
    tile_minmax = torch.empty(B, lib.frontend_linear_tiles(n_fft, n_frames), 2,
                              dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        arrived = _arrival_counter(B, y.device, stream)
        rc = lib.frontend_linear_f32(
            y.data_ptr(), bases.data_ptr(), out.data_ptr(), tile_minmax.data_ptr(),
            arrived.data_ptr(), B, T, n_fft, hop, n_frames, stream)
    if rc != 0:
        raise RuntimeError(f"frontend_linear_f32 launch failed: cudaError {rc}")
    launches += 1
    return out


def fused_spectrogram(y: torch.Tensor, mode: str = "linear",
                      mag_scale: str = "none", n_fft: int = 512,
                      spec_width: int = 256, quant: tuple[float, int] | None = None,
                      hop: int | None = None,
                      n_frames: int | None = None) -> torch.Tensor:
    """[B, T] float32 waveforms -> [B, n_fft//2+1, W] normalized |STFT|.

    Equivalent to spectrogram_batch(mode='linear', mag_scale='none') with
    librosa centering and hop = T // spec_width. Requires 2*hop >= n_fft.
    A CUDA tensor goes through the CUDA kernel, a CPU tensor through its
    plain version.
    """
    if mode != "linear" or mag_scale != "none" or quant is not None:
        raise NotImplementedError(
            f"fused_spectrogram(mode={mode!r}, mag_scale={mag_scale!r}, "
            f"quant={quant!r}): {_NOT_PORTED}")
    if y.dim() != 2 or y.dtype != torch.float32:
        raise ValueError(f"expected [B, T] float32 waveforms, got "
                         f"{tuple(y.shape)} {y.dtype}")
    hop, n_frames = _geometry(y.shape[1], n_fft, spec_width, hop, n_frames)
    if y.is_cuda:
        return _launch(y, n_fft, hop, n_frames)
    if y.device.type == "cpu":
        return fused_spectrogram_plain(y, n_fft, hop, n_frames)
    raise ValueError(f"fused_spectrogram runs on CUDA or CPU tensors, got {y.device}")


def fused_hybrid_frontend(y: torch.Tensor, n_fft: int, hop: int,
                          n_frames: int) -> torch.Tensor:
    """[B, T] -> [B, n_fft//2+1, n_frames] normalized |STFT| at an explicit
    geometry."""
    return fused_spectrogram(y, n_fft=n_fft, spec_width=n_frames, hop=hop,
                             n_frames=n_frames)


def _kernel_geometry_ok(cfg, T: int) -> bool:
    hop = max(1, T // cfg.spec_width)
    return 2 * hop >= cfg.fft_length


def frontend_input(y: torch.Tensor, cfg) -> torch.Tensor:
    """[B, T] -> model input [B, bins, W, 1] through the fused kernel.

    As in the JAX dispatch, the composition (ops/frontend.inputs_for_config)
    serves only what the kernel cannot: the 'raw' frontend, and geometries
    with 2*hop < n_fft. The librosa / mfcc / log_mel epilogues are not
    ported yet and raise. The composition's matmuls run with TF32 off; the
    kernel never uses TF32.
    """
    if cfg.audio_frontend == "raw" or not _kernel_geometry_ok(cfg, y.shape[1]):
        with full_fp32():
            return inputs_for_config(y, cfg)
    if cfg.audio_frontend != "hybrid":
        raise NotImplementedError(
            f"frontend_input for audio_frontend={cfg.audio_frontend!r}: {_NOT_PORTED}")
    return fused_spectrogram(y, n_fft=cfg.fft_length, spec_width=cfg.spec_width)[..., None]


def hybrid_frontend_input(y: torch.Tensor, cfg) -> torch.Tensor:
    """[B, T] -> [B, F, W, 1] hybrid model input whatever cfg.audio_frontend
    says; the composition serves geometries with 2*hop < n_fft."""
    if _kernel_geometry_ok(cfg, y.shape[1]):
        return fused_spectrogram(y, n_fft=cfg.fft_length, spec_width=cfg.spec_width)[..., None]
    with full_fp32():
        S = spectrogram_batch(y, sample_rate=cfg.sample_rate, n_fft=cfg.fft_length,
                              mel_bins=-1, spec_width=cfg.spec_width,
                              mag_scale="none", mode="linear")
    return S[..., None]
