"""Fused waveform -> normalized spectrogram features (port of
ops/pallas/frontend_kernel.py).

The TPU kernels `_kernel` (grid="sample") and `_kernel_tile` (grid="tile")
become two hand-written CUDA kernels for Hopper in
ops/csrc/frontend_kernel.cu, which share one DFT tile loop:

- the linear kernel: mode="linear", mag_scale="none", the hybrid frontend;
- the features kernel: every other float epilogue of `_sample_epilogue`,
  i.e. the mel product with mag_scale none / pwl / db / pcen, log_mel,
  mfcc (power, mel, power_to_db over all frames, DCT, slice), and the
  linear mode with pwl / db / pcen.

Each has an int8-entry specialisation (`quant=(scale, zero_point)`, the
last step of `_sample_epilogue`): the same normalized features, quantized
as round_half_away(S * float32(1 / scale)) + zero_point, clipped to int8,
into the INT8 executor's entry tensor [B, 1, W, bins] (the graph's entry
QUANTIZE -> TRANSPOSE folded in). Its codes equal the executor's quantize
of the float kernel's output, bit for bit.

The source note says what bounds them (bytes; in practice their fp32 FMA
DFT) and how the design handles a sample larger than shared memory.

`fused_spectrogram` dispatches on the tensor's device and nothing else:

- CUDA tensor: launches a kernel (built with nvcc on first use), counts the
  launch in the module attribute `launches` under the specialisation's
  name (`kernel_name`), or raises;
- CPU tensor: runs `fused_spectrogram_plain` (with `quant`, then
  `quantize_entry`), the same function in plain PyTorch, which the CPU
  tests hold against the JAX kernel and which the chip smoke test holds
  the CUDA kernels against.

`frontend_input` serves the hybrid, librosa, log_mel and mfcc frontends
through the kernels, pcen included: the JAX dispatch keeps pcen on the XLA
composition only because Mosaic cannot lower its associative scan, and
CUDA has no such limit (the kernel runs pcen's smoother one thread per
channel, frame by frame).

The two grids. grid="sample" gives each sample its own 64-row strips;
grid="tile" stacks the frames of `batch_tile` samples along rows, as
`_kernel_tile` does, and the same kernels walk the stack in strips that may
straddle samples (`tile_layout` says which strips each sample of a group
has; the kernel arrives at every sample it touches). Every sum keeps the
sample grid's order, so both grids give the same values bit for bit; the
tile grid writes its float features frame-major and returns them through a
transposed view, as the TPU kernel's caller transposes outside the kernel.
Only the frontend benchmark (scripts/bench_frontend.py) passes
grid="tile"; serving uses the sample grid, as in the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from birdnet_stm32_tpu_torch.config import VALID_MAG_SCALES
from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.ops.dct import dct_matrix
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from birdnet_stm32_tpu_torch.ops.magnitude import pcen_coefficients
from birdnet_stm32_tpu_torch.ops.mel import mel_filterbank
from birdnet_stm32_tpu_torch.ops.spectrogram import (
    VALID_MODES,
    spectrogram_batch,
    spectrogram_epilogue,
)
from birdnet_stm32_tpu_torch.ops.stft import dft_bases_tensor, stft_magnitude
from birdnet_stm32_tpu_torch.quant.tflite_import import f32_reciprocal, quantize_f32

# Rows of a strip, the kernels' BM (checked against the built library).
STRIP_ROWS = 64
# Kernel launches since the last clear(), by kernel_name(mode, mag_scale,
# quant, grid); the plain (CPU) path never counts.
launches: collections.Counter[str] = collections.Counter()
# The CUDA kernel's Epilogue codes (ops/csrc/frontend_kernel.cu).
_EPILOGUES = {"none": 0, "pwl": 1, "db": 2, "pcen": 3, "log_mel": 4, "mfcc": 5}
FRONTEND_MODES = {"hybrid": "linear", "librosa": "mel", "mfcc": "mfcc",
                   "log_mel": "log_mel"}


def kernel_name(mode: str, mag_scale: str, quant: bool = False, grid: str = "sample") -> str:
    """The specialisation a (mode, mag_scale) launches, `_int8` with the
    int8-entry epilogue, `_tile` on the tile grid: log_mel and mfcc ignore
    mag_scale, as the reference does."""
    if mode in ("log_mel", "mfcc") or mag_scale == "none":
        name = f"fused_spectrogram_{mode}"
    else:
        name = f"fused_spectrogram_{mode}_{mag_scale}"
    if quant:
        name += "_int8"
    return name + "_tile" if grid == "tile" else name


def _check_grid(grid: str, B: int, batch_tile: int) -> None:
    """The JAX contract: a known grid, and whole groups on the tile grid."""
    if grid not in ("sample", "tile"):
        raise ValueError(f"grid must be 'sample'|'tile', got {grid!r}")
    if grid == "tile" and (batch_tile < 1 or B % batch_tile):
        raise ValueError(f"grid='tile' requires B % batch_tile == 0, got B={B} "
                         f"batch_tile={batch_tile}")


def tile_layout(n_frames: int, tile: int, strip_rows: int = STRIP_ROWS) -> np.ndarray:
    """[tile, 2] int32: for sample g of a group of `tile` samples whose
    frames are stacked along rows (row r is frame r % n_frames of sample
    r // n_frames), the first strip of `strip_rows` rows that holds one of
    its rows, and how many strips do. The kernels count a sample's arriving
    blocks against its number of strips."""
    g = np.arange(tile)
    first = g * n_frames // strip_rows
    last = ((g + 1) * n_frames - 1) // strip_rows
    return np.stack([first, last - first + 1], axis=1).astype(np.int32)


def _geometry(mode: str, T: int, n_fft: int, spec_width: int, hop: int | None,
              n_frames: int | None) -> tuple[int, int, int]:
    """(hop, frames computed, frames out). mfcc's power_to_db stats run over
    all 1 + T//hop frames before the slice to spec_width; the other modes
    slice first."""
    if hop is None:
        hop = max(1, T // spec_width) if spec_width > 0 else n_fft // 2
    if 2 * hop < n_fft:
        raise ValueError(f"fused frontend requires 2*hop >= n_fft, got {hop=} {n_fft=}")
    n_frames_full = 1 + T // hop
    if n_frames is None:
        if mode == "mfcc" or spec_width <= 0:
            n_frames = n_frames_full
        else:
            n_frames = min(spec_width, n_frames_full)
    out_w = min(spec_width, n_frames) if mode == "mfcc" and spec_width > 0 else n_frames
    return hop, n_frames, out_w


def fused_spectrogram_plain(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                            mode: str = "linear", mag_scale: str = "none",
                            sample_rate: int = 22050, mel_bins: int = 64,
                            n_mfcc: int = 20, out_w: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: [B, T] -> [B, bins, out_w].

    Centre-pads, frames row k ++ row k+1 of the [n_frames+1, hop] view,
    takes |frames @ windowed DFT bases| in float32 (ops/stft.py), then the
    mode x mag_scale epilogue of ops/spectrogram.py. With 2*hop >= n_fft
    no frame reaches past (n_frames+1)*hop samples, so this equals the
    reference's pad-and-cut (n_fft//2 on the left, exactly (n_frames+1)*hop
    samples kept).
    """
    S = stft_magnitude(y, n_fft=n_fft, hop=hop, n_frames=n_frames)  # [B, W, F]
    return spectrogram_epilogue(S, mode, mag_scale, sample_rate, n_fft, hop,
                                -1 if mode == "linear" else mel_bins, n_mfcc,
                                n_frames if out_w is None else out_w)


def quantize_entry(S: torch.Tensor, quant: tuple[float, int]) -> torch.Tensor:
    """Plain int8-entry epilogue: [B, bins, W] normalized features ->
    [B, 1, W, bins] int8 codes, round_half_away(S * float32(1 / scale)) + zp
    clipped to int8 (the executor's entry QUANTIZE, transposed)."""
    scale, zp = quant
    return quantize_f32(S.transpose(1, 2), f32_reciprocal(scale, S.device), int(zp))[:, None]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from birdnet_stm32_tpu_torch.ops.kernels import _build

    lib = _build.load("frontend_kernel")
    for fn in (lib.frontend_strip_rows, lib.frontend_bin_tile):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.frontend_linear_bin_pad.argtypes = [ctypes.c_int]
    lib.frontend_linear_bin_pad.restype = ctypes.c_int
    lib.frontend_linear.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                      ctypes.c_void_p])
    lib.frontend_linear.restype = ctypes.c_int
    lib.frontend_features.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.frontend_features.restype = ctypes.c_int
    if lib.frontend_strip_rows() != STRIP_ROWS:
        raise RuntimeError(f"frontend_kernel.cu strips {lib.frontend_strip_rows()} rows, "
                           f"tile_layout assumes {STRIP_ROWS}")
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


@functools.lru_cache(maxsize=16)
def _kernel_mel_bank(sample_rate: int, n_fft: int, mel_bins: int, f_pad: int,
                     device: torch.device) -> torch.Tensor:
    """[f_pad, mel_bins] Slaney mel bank (fmin 150, fmax sr//2), zero rows
    past F."""
    fb = torch.zeros(f_pad, mel_bins, dtype=torch.float32)
    fb[: n_fft // 2 + 1] = torch.from_numpy(
        mel_filterbank(sample_rate, n_fft, mel_bins, fmin=150.0, fmax=float(sample_rate // 2)))
    return fb.to(device)


@functools.lru_cache(maxsize=16)
def _kernel_dct(mel_bins: int, n_mfcc: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dct_matrix(mel_bins, n_mfcc)).to(device)


# Per-sample arrival counters, one buffer per (device, stream), shared by
# both kernels: each leaves them at zero when it ends, so they are zeroed
# only when allocated.
_arrival_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _arrival_counter(B: int, device: torch.device, stream: int) -> torch.Tensor:
    key = (device, stream)
    buf = _arrival_counters.get(key)
    if buf is None or buf.numel() < B:
        buf = torch.zeros(B, dtype=torch.int32, device=device)
        _arrival_counters[key] = buf
    return buf


@functools.lru_cache(maxsize=16)
def _kernel_layout(n_frames: int, tile: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """tile_layout on `device`, and the most strips a sample has."""
    layout = tile_layout(n_frames, tile)
    return torch.from_numpy(layout).to(device), int(layout[:, 1].max())


def _check_launch(y: torch.Tensor, n_fft: int, tile: int) -> None:
    if not y.is_contiguous():
        raise ValueError("fused_spectrogram kernel needs a contiguous [B, T] tensor")
    if n_fft % 32:
        raise ValueError(f"fused_spectrogram kernel needs n_fft % 32 == 0, got {n_fft}")
    if not 0 < y.shape[0] // tile <= 65535:
        raise ValueError(f"fused_spectrogram kernel takes 1..65535 groups of {tile} "
                         f"samples, got {y.shape[0]} samples")


def _int8_out(quant, B: int, out_w: int, bins: int, device) -> tuple:
    """(int8 output or None, float32 1/scale, zero point) for a launch."""
    if quant is None:
        return None, 0.0, 0
    scale, zp = quant
    out8 = torch.empty(B, 1, out_w, bins, dtype=torch.int8, device=device)
    return out8, float(np.float32(1.0) / np.float32(scale)), int(zp)


# On the launchers: `tile` None is the sample grid (groups of one sample,
# float output freq-major [B, bins, W]); an int is the tile grid (float
# output frame-major, returned as the kernel wrote it, [B, W, bins]). The
# int8 codes are [B, 1, W, bins] on either grid.


def _frame_major(quant, tile: int | None) -> bool:
    """Whether a kernel stores frame-major: the tile grid's float result
    and every int8 launch (its codes, and the float buffer behind them)."""
    return tile is not None or quant is not None


def _launch_linear(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                   quant: tuple[float, int] | None, tile: int | None) -> torch.Tensor:
    B, T = y.shape
    lib = _lib()
    f_pad = lib.frontend_linear_bin_pad(n_fft)
    bases = _kernel_bases(n_fft, f_pad, y.device)
    nbin = n_fft // 2 + 1
    group = tile or 1
    frame_major = _frame_major(quant, tile)
    layout, most_strips = _kernel_layout(n_frames, group, y.device)
    slots = most_strips * (f_pad // lib.frontend_bin_tile())
    # The result, or with quant the frame-major scratch the codes come from.
    shape = (B, n_frames, nbin) if frame_major else (B, nbin, n_frames)
    out = torch.empty(shape, dtype=torch.float32, device=y.device)
    out8, inv_scale, zp = _int8_out(quant, B, n_frames, nbin, y.device)
    tile_minmax = torch.empty(B, slots, 2, dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        arrived = _arrival_counter(B, y.device, stream)
        rc = lib.frontend_linear(
            y.data_ptr(), bases.data_ptr(), out.data_ptr(),
            None if out8 is None else out8.data_ptr(), tile_minmax.data_ptr(),
            arrived.data_ptr(), layout.data_ptr(), B, T, n_fft, hop, n_frames, group, slots,
            int(frame_major), inv_scale, zp, stream)
    if rc != 0:
        raise RuntimeError(f"frontend_linear launch failed: cudaError {rc}")
    launches[kernel_name("linear", "none", quant is not None,
                         "sample" if tile is None else "tile")] += 1
    return out if out8 is None else out8


def _launch_features(y: torch.Tensor, mode: str, mag_scale: str, sample_rate: int,
                     n_fft: int, mel_bins: int, n_mfcc: int, hop: int, n_frames: int,
                     out_w: int, quant: tuple[float, int] | None,
                     tile: int | None) -> torch.Tensor:
    B, T = y.shape
    lib = _lib()
    f_pad = lib.frontend_linear_bin_pad(n_fft)
    bases = _kernel_bases(n_fft, f_pad, y.device)
    n_mel = 0 if mode == "linear" else mel_bins
    mel_fb = _kernel_mel_bank(sample_rate, n_fft, n_mel, f_pad, y.device) if n_mel else None
    dct = _kernel_dct(n_mel, n_mfcc, y.device) if mode == "mfcc" else None
    channels = n_mel or n_fft // 2 + 1
    scratch = torch.empty(B, n_frames, channels, dtype=torch.float32, device=y.device)
    bins = n_mfcc if mode == "mfcc" else channels
    group = tile or 1
    frame_major = _frame_major(quant, tile)
    # The result, or with quant the scratch of pcen's smoother and mfcc's DCT.
    shape = (B, out_w, bins) if frame_major else (B, bins, out_w)
    out = torch.empty(shape, dtype=torch.float32, device=y.device)
    out8, inv_scale, zp = _int8_out(quant, B, out_w, bins, y.device)
    epi = _EPILOGUES[mode if mode in ("log_mel", "mfcc") else mag_scale]
    pcen_a, pcen_b = (pcen_coefficients(sample_rate, hop) if epi == _EPILOGUES["pcen"]
                      else (0.0, 0.0))
    layout, _ = _kernel_layout(n_frames, group, y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        arrived = _arrival_counter(B, y.device, stream)
        rc = lib.frontend_features(
            y.data_ptr(), bases.data_ptr(), None if mel_fb is None else mel_fb.data_ptr(),
            None if dct is None else dct.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            None if out8 is None else out8.data_ptr(), arrived.data_ptr(), layout.data_ptr(),
            B, T, n_fft, hop, n_frames, n_mel, n_mfcc, out_w, epi, pcen_a, pcen_b, group,
            int(frame_major), inv_scale, zp, stream)
    if rc != 0:
        raise RuntimeError(f"frontend_features launch failed: cudaError {rc}")
    launches[kernel_name(mode, mag_scale, quant is not None,
                         "sample" if tile is None else "tile")] += 1
    return out if out8 is None else out8


def fused_spectrogram(y: torch.Tensor, mode: str = "linear", mag_scale: str = "none",
                      sample_rate: int = 22050, n_fft: int = 512, mel_bins: int = 64,
                      spec_width: int = 256, n_mfcc: int = 20,
                      quant: tuple[float, int] | None = None, hop: int | None = None,
                      n_frames: int | None = None, grid: str = "sample",
                      batch_tile: int = 8) -> torch.Tensor:
    """[B, T] float32 waveforms -> [B, bins, W] normalized features, or with
    `quant=(scale, zero_point)` the INT8 executor's entry tensor
    [B, 1, W, bins] int8.

    Equivalent to spectrogram_batch(...) for the same (mode, mag_scale) with
    librosa centering and hop = T // spec_width; bins = n_fft//2+1 (linear),
    mel_bins (mel, log_mel) or n_mfcc (mfcc). Requires 2*hop >= n_fft. A
    CUDA tensor goes through a CUDA kernel, a CPU tensor through the plain
    version. Two grids, as in the JAX package: 'sample' (any B; batch_tile
    is ignored) and 'tile' (batch_tile samples per group, B % batch_tile ==
    0, the same values; its float result is a transposed view of a
    frame-major buffer).
    """
    if mode not in VALID_MODES:
        raise ValueError(f"Invalid mode: {mode!r}")
    if mag_scale not in VALID_MAG_SCALES:
        raise ValueError(f"Invalid mag_scale: {mag_scale!r}")
    if mode != "linear" and mel_bins <= 0:
        raise ValueError(f"mode {mode!r} needs mel_bins > 0, got {mel_bins}")
    if y.dim() != 2 or y.dtype != torch.float32:
        raise ValueError(f"expected [B, T] float32 waveforms, got "
                         f"{tuple(y.shape)} {y.dtype}")
    _check_grid(grid, y.shape[0], batch_tile)
    hop, n_frames, out_w = _geometry(mode, y.shape[1], n_fft, spec_width, hop, n_frames)
    tile = batch_tile if grid == "tile" else None
    if y.is_cuda:
        _check_launch(y, n_fft, tile or 1)
        if mode == "linear" and mag_scale == "none":
            out = _launch_linear(y, n_fft, hop, n_frames, quant, tile)
        else:
            out = _launch_features(y, mode, mag_scale, sample_rate, n_fft, mel_bins, n_mfcc,
                                   hop, n_frames, out_w, quant, tile)
        # The tile grid's float features come frame-major, [B, W, bins].
        return out.transpose(1, 2) if tile is not None and quant is None else out
    if y.device.type == "cpu":
        # Both grids compute the same function: one plain version serves both.
        S = fused_spectrogram_plain(y, n_fft, hop, n_frames, mode=mode, mag_scale=mag_scale,
                                    sample_rate=sample_rate, mel_bins=mel_bins,
                                    n_mfcc=n_mfcc, out_w=out_w)
        return S if quant is None else quantize_entry(S, quant)
    raise ValueError(f"fused_spectrogram runs on CUDA or CPU tensors, got {y.device}")


def fused_hybrid_frontend(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                          batch_tile: int = 8, grid: str = "sample") -> torch.Tensor:
    """[B, T] -> [B, n_fft//2+1, n_frames] normalized |STFT| at an explicit
    geometry, on either grid."""
    return fused_spectrogram(y, n_fft=n_fft, spec_width=n_frames, hop=hop,
                             n_frames=n_frames, batch_tile=batch_tile, grid=grid)


def _kernel_geometry_ok(cfg, T: int) -> bool:
    hop = max(1, T // cfg.spec_width)
    return 2 * hop >= cfg.fft_length


def frontend_input(y: torch.Tensor, cfg,
                   quant: tuple[float, int] | None = None) -> torch.Tensor:
    """[B, T] -> model input [B, bins, W, 1] through the fused kernels, for
    the hybrid, librosa (any mag_scale, pcen included), log_mel and mfcc
    frontends; with `quant=(scale, zero_point)` (entry_quant_params of the
    graph) the INT8 executor's entry tensor [B, 1, W, bins] int8 instead
    (feed build_executor(prequantized_input=True)).

    As in the JAX dispatch, mag_scale is passed on only in mode 'mel', and
    the composition (ops/frontend.inputs_for_config) serves only the 'raw'
    frontend and geometries with 2*hop < n_fft. Its matmuls run with TF32
    off; the kernels never use TF32. The composition has no int8 epilogue:
    `quant` there raises ValueError.
    """
    mode = FRONTEND_MODES.get(cfg.audio_frontend)
    if mode is None or not _kernel_geometry_ok(cfg, y.shape[1]):
        if quant is not None:
            raise ValueError(
                "in-kernel quantization has no composition fallback (frontend "
                f"{cfg.audio_frontend!r}, 2*hop >= n_fft required); callers gate "
                "on the kernel geometry and quantize in the executor")
        with full_fp32():
            return inputs_for_config(y, cfg)
    out = fused_spectrogram(
        y, mode=mode, mag_scale=cfg.mag_scale if mode == "mel" else "none",
        sample_rate=cfg.sample_rate, n_fft=cfg.fft_length, mel_bins=cfg.num_mels,
        spec_width=cfg.spec_width, n_mfcc=cfg.n_mfcc, quant=quant)
    return out if quant is not None else out[..., None]


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
