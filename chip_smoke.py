"""Smoke test of the PyTorch/CUDA port (birdnet_stm32_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA device (an H100):

    python3 chip_smoke.py

It imports nothing of JAX. In order it:

1. turns TF32 off for matmuls and cuDNN;
2. builds every CUDA kernel of the port from ops/csrc/ with nvcc and
   prints the build seconds and the compiler's register/spill report, then
   each kernel-phase specialisation's dynamic shared memory and blocks per
   SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at the flagship
   geometry;
3. kernel phase: at the flagship geometry (B=64, T=66150, n_fft 512, hop
   258, 256 frames, 64 mels, 20 mfcc) holds each specialisation of the
   fused frontend kernels against its plain PyTorch version on the card
   (max abs <= 1e-5 for linear, 2e-5 for the others), times kernel, plain
   version and a torch.stft yardstick with CUDA events, and checks the
   kernel again after the timing launches; each entry carries
   fraction_of_bound = bound_ms / ms. The int8-entry specialisations
   (linear; mel + pwl), quantizing with the entry (scale, zero point) of
   the INT8 graph, must equal quantize(the float kernel's output) bit for
   bit, and quantize(the plain version) within one code on fewer than 1 %
   of codes. Then the FFT sizes: the linear and mel + pwl kernels at
   n_fft 64, 128, 256, 1024 and 2048 (hop n_fft / 2, B=16, T=66150)
   against their plain versions, within the same tolerances;
4. slice phase: loads artifacts/flagship/bundle/model_config.json and
   derives one config per served frontend with dataclasses.replace:
   hybrid (the flagship) and librosa + pwl get three requests of 64 chunks
   and a ragged one of 37; librosa + none / db / pcen, log_mel and mfcc one
   request of 64. Each config gets a full-width DS-CNN with seeded weights
   and is served through make_fused_classifier + classify_in_batches on
   CUDA. Checks per config: scores [N, 100], finite, rows sum to 1 within
   1e-5, the config's kernel launched once per batch and no other kernel
   launched, and one batch's scores match the same port run on the CPU
   (plain frontend, same weights) within 1e-4. For hybrid and librosa +
   pwl it also times one warm 64-chunk batch by part: host-to-device copy,
   frontend, DS-CNN, whole;
5. INT8 phase: the committed flagship graph
   (artifacts/flagship/bundle/model_quantized.tflite), read by the port's
   own reader, served through TFLiteSimRunner + make_fused_classifier +
   classify_in_batches on the hybrid requests (3 x 64 + 37):
   (a) the flagship graph: scores [229, 100], finite, in [0, 1]; the
       linear float kernel launched once per batch and no int8 kernel;
       one batch's scores bit-equal to the port's CPU executor on the same
       features, copied to the host;
   (b) the entry-transpose fixture (tests/int8_fixture.py: ops 1-2 become
       TRANSPOSE (0, 3, 2, 1) and RESHAPE, the same function): the fused
       leg, the linear int8 kernel launched once per batch and the float
       one never; scores bit-equal to (a)'s;
   (c) the CUDA executor on the golden's features bit-equal to
       tests/goldens/torch_int8_flagship_scores.npz;
   (d) one warm 64-chunk batch of each leg by part (copy, frontend,
       executor, whole), and the CUDA launches its executor makes with
       their summed device time (torch.profiler);
6. tile phase: the tile grid (grid="tile", the port of _kernel_tile) of
   every specialisation of the kernel phase at each batch_tile of 2, 4, 8
   and 16, on the kernel phase's input: bit-equal to the sample-grid
   kernel, within the kernel phase's tolerance of the plain version, the
   same again after its timing launches; times by CUDA
   events; and grid="tile" at B=6 with batch_tile 4 raises ValueError;
7. bench phase: the port's frontend benchmark entry
   (birdnet_stm32_tpu_torch/scripts/bench_frontend.py) at B=256 on CUDA,
   with the launch counts cleared just before: its numerics within 1e-5 of
   the composition; on the B=256 input it times, the sample grid within
   1e-5 of the composition and every tile's features finite, bit-equal to
   the sample grid and within 1e-5; the INT8 scores finite, their entry
   codes at most one apart on under 1 %, min cosine >= BENCH_MIN_COSINE;
   and the tile-grid kernel launched; it prints the bench's three
   sections;
8. prints the `kernels` JSON line, the card's name and power limit, and
   last the `ok` JSON line.

Any failed check exits non-zero before the `ok` line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, T, N_FFT, SPEC_WIDTH, N_MELS, N_MFCC, SR = 64, 66150, 512, 256, 64, 20, 22050
REQUESTS = (64, 64, 64, 37)
TILES = (2, 4, 8, 16)
# The other n_fft the kernels' FFT takes (the flagship's 512 is the kernel
# phase's), each at hop n_fft / 2 on SWEEP_B waveforms of T samples.
SWEEP_N_FFT = (64, 128, 256, 1024, 2048)
SWEEP_B = 16
BENCH_B = 256
# The bench's INT8 score agreement between its two feeds on 32 chunks: an
# H100 80GB HBM3 read a min cosine of 0.999085 here; a feature near a code
# boundary flips one entry code, and the bit-exact executor carries it on.
BENCH_MIN_COSINE = 0.998
KERNEL_SOURCE = "birdnet_stm32_tpu_torch/ops/csrc/frontend_kernel.cu"
JAX_KERNEL = "birdnet_stm32_tpu/ops/pallas/frontend_kernel.py"
FP32_PEAK_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12
FLAGSHIP_TFLITE = ROOT / "artifacts/flagship/bundle/model_quantized.tflite"
INT8_GOLDEN = ROOT / "tests/goldens/torch_int8_flagship_scores.npz"
# (mode, mag_scale, int8 entry, served path or None) of each kernel
# specialisation held in the kernel phase.
SPECS = (("linear", "none", False, "hybrid"), ("mel", "none", False, "librosa+none"),
         ("mel", "pwl", False, "librosa+pwl"), ("mel", "db", False, "librosa+db"),
         ("mel", "pcen", False, "librosa+pcen"), ("log_mel", "none", False, "log_mel"),
         ("mfcc", "none", False, "mfcc"),
         ("linear", "none", True, "INT8 leg, fused entry (entry-transpose graph)"),
         # No graph the repo makes starts with QUANTIZE -> TRANSPOSE after a
         # mel frontend, so this one has no served path; held on the card only.
         ("mel", "pwl", True, None))
# Operations per output element of the int8-entry epilogue: multiply, |.|,
# + 0.5, floor, sign, + zp, clamp.
QUANT_OPS = 7
# (audio_frontend, mag_scale or None to keep the flagship's, requests).
SERVED = (("hybrid", None, REQUESTS), ("librosa", "pwl", REQUESTS),
          ("librosa", "none", (64,)), ("librosa", "db", (64,)),
          ("librosa", "pcen", (64,)), ("log_mel", None, (64,)), ("mfcc", None, (64,)))
# Operations per post-mel element in the epilogue beyond min, max,
# subtract and divide (4): pwl's second min-max and curve, dB's log,
# pcen's smoother and four transcendentals, log1p, mfcc's dB and clamp.
SCALE_OPS = {"none": 0, "pwl": 16, "db": 8, "pcen": 14, "log_mel": 1, "mfcc": 6}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flagship_wave(torch):
    """The kernel and tile phases' input: [B, T] from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(0)
    return 0.5 * torch.randn(B, T, generator=g, device="cuda")


def compare(got, ref, int8: bool, name: str, what: str | None = "plain version") -> float:
    """Max abs difference; for codes, also fail at >= 1 % differing from
    `what` (no check when it is None)."""
    if not int8:
        return (got - ref).abs().max().item()
    diff = (got.int() - ref.int()).abs()
    share = (diff > 0).float().mean().item()
    if what and not share < 0.01:
        fail(f"{name}: {share:.4%} of codes differ from the {what} (>= 1 %)")
    return diff.max().item()


def build_phase() -> None:
    from birdnet_stm32_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    print(json.dumps({"build_seconds": round(time.perf_counter() - t0, 3),
                      "nvcc_seconds": {k: round(v, 3) for k, v in per_source.items()}}))
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"ptxas {name}: {line.strip()}")


def occupancy_phase() -> None:
    """Each kernel-phase specialisation's dynamic shared memory and blocks
    per SM at the flagship geometry."""
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import kernel_name, kernel_occupancy

    hop = T // SPEC_WIDTH
    report = {}
    for mode, mag, int8, _ in SPECS:
        for grid in ("sample", "tile"):
            n_frames = 1 + T // hop if mode == "mfcc" else SPEC_WIDTH
            report[kernel_name(mode, mag, int8, grid)] = kernel_occupancy(
                mode, mag, int8, grid, n_fft=N_FFT, n_frames=n_frames, sample_rate=SR,
                mel_bins=N_MELS)
    print(json.dumps({"occupancy": report}))


def bound(np, mode: str, mag: str, n_frames: int, bins: int,
          int8: bool = False) -> tuple[float, str]:
    """Least time for the function at this run's shapes, whatever the
    algorithm: each waveform sample read once and each feature written once
    (4 bytes, or 1 for an int8 code), against the operations of the FFT
    route (real-input FFT ~2.5 n log2 n, the window, |.| = 2 mul + add +
    sqrt per bin), the mel bank's nonzeros (one multiply-add each), mfcc's
    DCT, and the epilogue per element (the quantize too, for int8)."""
    from birdnet_stm32_tpu_torch.ops.mel import mel_filterbank

    n_bins = N_FFT // 2 + 1
    per_frame = 2.5 * N_FFT * math.log2(N_FFT) + N_FFT + 4 * n_bins
    if mode == "linear":
        channels = n_bins
    else:
        channels = N_MELS
        per_frame += 2 * np.count_nonzero(mel_filterbank(SR, N_FFT, N_MELS, fmin=150.0,
                                                         fmax=float(SR // 2)))
    ops = n_frames * (per_frame + channels * (4 + SCALE_OPS[mode if mode in SCALE_OPS else mag]))
    if mode == "mfcc":
        ops += SPEC_WIDTH * N_MFCC * (2 * N_MELS + 4)
    if int8:
        ops += SPEC_WIDTH * bins * QUANT_OPS
    ops *= B
    n_bytes = 4.0 * B * T + (1.0 if int8 else 4.0) * B * bins * SPEC_WIDTH
    t_ops, t_bytes = ops / FP32_PEAK_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_phase(torch, np, quant: tuple[float, int]) -> list[dict]:
    """Hold, time and bound every specialisation of SPECS; `quant` is the
    INT8 graph's entry (scale, zero point)."""
    from birdnet_stm32_tpu_torch.device import full_fp32
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
        fused_spectrogram,
        fused_spectrogram_plain,
        kernel_name,
        quantize_entry,
    )
    from birdnet_stm32_tpu_torch.ops.spectrogram import spectrogram_epilogue

    hop = T // SPEC_WIDTH
    y = flagship_wave(torch)
    window = torch.hann_window(N_FFT, periodic=True, device="cuda")
    entries = []
    for mode, mag, int8, served in SPECS:
        name = kernel_name(mode, mag, int8)
        n_frames = 1 + T // hop if mode == "mfcc" else SPEC_WIDTH
        bins = {"linear": N_FFT // 2 + 1, "mfcc": N_MFCC}.get(mode, N_MELS)
        geometry = dict(n_fft=N_FFT, hop=hop, n_frames=n_frames, mode=mode, mag_scale=mag,
                        sample_rate=SR, mel_bins=N_MELS, n_mfcc=N_MFCC, out_w=SPEC_WIDTH)
        q = quant if int8 else None

        def kernel(q=q):
            return fused_spectrogram(y, mode=mode, mag_scale=mag, sample_rate=SR,
                                     n_fft=N_FFT, mel_bins=N_MELS, spec_width=SPEC_WIDTH,
                                     n_mfcc=N_MFCC, quant=q)

        def plain():
            S = fused_spectrogram_plain(y, **geometry)
            return S if q is None else quantize_entry(S, q)

        def library():
            S = torch.stft(y, N_FFT, hop_length=hop, window=window, center=True,
                           pad_mode="constant", return_complex=True).abs()[..., :n_frames]
            S = spectrogram_epilogue(S.transpose(1, 2), mode, mag, SR, N_FFT, hop,
                                     -1 if mode == "linear" else N_MELS, N_MFCC, SPEC_WIDTH)
            return S if q is None else quantize_entry(S, q)

        def error(got, ref, what="plain version"):
            return compare(got, ref, int8, name, what)

        tol = 1 if int8 else 1e-5 if mode == "linear" else 2e-5
        shape = (B, 1, SPEC_WIDTH, bins) if int8 else (B, bins, SPEC_WIDTH)
        with full_fp32():
            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            lib = library()
            torch.cuda.synchronize()
            if got.shape != shape or (not int8 and not torch.isfinite(got).all()):
                fail(f"{name} output {tuple(got.shape)} not finite {shape}")
            err = error(got, ref)
            report = {"kernel": name, "max_abs_vs_plain": err,
                      "max_abs_vs_torch_stft": error(got, lib, what=None)}
            if int8:
                # Bit for bit the executor's quantize of the float kernel.
                same = torch.equal(got, quantize_entry(kernel(None), q))
                report["equals_quantize_of_float_kernel"] = same
                report["codes_differing_vs_plain"] = (got != ref).float().mean().item()
                if not same:
                    fail(f"{name} != quantize(float kernel output)")
            print(json.dumps(report))
            if not err <= tol:
                fail(f"{name} kernel vs plain: max abs {err} > {tol}")
            ms = cuda_ms(torch, kernel)
            plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
            library_ms = cuda_ms(torch, library, iters=5, warmup=1)
            # The kernels reset their arrival counters themselves: after the
            # timed launches each must still finish every sample.
            err_after = error(kernel(), ref)
            if not err_after <= tol:
                fail(f"{name} kernel after the timing launches: max abs {err_after} > {tol} "
                     "(arrival counters not reset?)")
        bound_ms, bound_by = bound(np, mode, mag, n_frames, bins, int8)
        entries.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": f"{JAX_KERNEL}:" + ("126" if int8 else "154"),
                        "launches": None, "max_abs_err": max(err, err_after), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "fraction_of_bound": bound_ms / ms, "library_ms": library_ms,
                        "served_path": served})
    return entries


def sweep_phase(torch) -> None:
    """The linear and mel + pwl kernels at every n_fft of SWEEP_N_FFT
    against their plain versions (max abs 1e-5 / 2e-5)."""
    from birdnet_stm32_tpu_torch.device import full_fp32
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
        fused_spectrogram,
        fused_spectrogram_plain,
    )

    y = flagship_wave(torch)[:SWEEP_B].contiguous()
    errs = {}
    for n_fft in SWEEP_N_FFT:
        hop = n_fft // 2
        n_frames = T // hop
        for mode, mag, tol in (("linear", "none", 1e-5), ("mel", "pwl", 2e-5)):
            kw = dict(mode=mode, mag_scale=mag, sample_rate=SR, mel_bins=N_MELS)
            with full_fp32():
                got = fused_spectrogram(y, n_fft=n_fft, spec_width=n_frames, hop=hop,
                                        n_frames=n_frames, **kw)
                ref = fused_spectrogram_plain(y, n_fft, hop, n_frames, **kw)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item() if got.shape == ref.shape else math.inf
            errs[f"{mode}_{mag}_n_fft_{n_fft}"] = err
            if not (err <= tol and torch.isfinite(got).all()):
                fail(f"{mode} + {mag} at n_fft {n_fft}: {tuple(got.shape)} vs "
                     f"{tuple(ref.shape)}, max abs {err} > {tol}")
    print(json.dumps({"fft_sizes_max_abs_vs_plain": errs}))


def tile_phase(torch, np, quant: tuple[float, int], sample_entries: list[dict]) -> list[dict]:
    """The tile grid of every specialisation of SPECS at each tile of
    TILES, on the kernel phase's input; `sample_entries` are the kernel
    phase's entries, in SPECS order (their bound, plain version and library
    call are this function's too: the tile grid computes the same
    function)."""
    from birdnet_stm32_tpu_torch.device import full_fp32
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
        fused_spectrogram,
        fused_spectrogram_plain,
        kernel_name,
        quantize_entry,
    )

    hop = T // SPEC_WIDTH
    y = flagship_wave(torch)
    entries = []
    for (mode, mag, int8, _), sample_entry in zip(SPECS, sample_entries):
        name = kernel_name(mode, mag, int8, "tile")
        n_frames = 1 + T // hop if mode == "mfcc" else SPEC_WIDTH
        q = quant if int8 else None
        kw = dict(mode=mode, mag_scale=mag, sample_rate=SR, mel_bins=N_MELS, n_mfcc=N_MFCC)
        tol = 1 if int8 else 1e-5 if mode == "linear" else 2e-5
        ms, errs = {}, []
        with full_fp32():
            sample = fused_spectrogram(y, n_fft=N_FFT, spec_width=SPEC_WIDTH, quant=q, **kw)
            # The plain version of both grids (they compute one function).
            ref = fused_spectrogram_plain(y, N_FFT, hop, n_frames, out_w=SPEC_WIDTH, **kw)
            ref = ref if q is None else quantize_entry(ref, q)
            for tile in TILES:
                def kernel(tile=tile):
                    return fused_spectrogram(y, n_fft=N_FFT, spec_width=SPEC_WIDTH, quant=q,
                                             grid="tile", batch_tile=tile, **kw)

                got = kernel()
                torch.cuda.synchronize()
                if not torch.equal(got, sample):
                    fail(f"{name} tile {tile} != the sample grid: max abs "
                         f"{(got.float() - sample.float()).abs().max().item()}")
                errs.append(compare(got, ref, int8, f"{name} tile {tile}"))
                ms[str(tile)] = cuda_ms(torch, kernel)
                after = kernel()
                torch.cuda.synchronize()
                errs.append(compare(after, ref, int8, f"{name} tile {tile}"))
                if not torch.equal(after, sample) or not max(errs) <= tol:
                    fail(f"{name} tile {tile}: after the timing launches equal to the sample "
                         f"grid {torch.equal(after, sample)}, vs plain {max(errs)} (tol {tol})")
        print(json.dumps({"kernel": name, "equals_sample_grid": True,
                          "max_abs_vs_plain": max(errs), "ms_by_tile": ms,
                          "sample_grid_ms": sample_entry["ms"]}))
        served = ("frontend bench (birdnet_stm32_tpu_torch/scripts/bench_frontend.py)"
                  if (mode, mag, int8) == ("linear", "none", False) else None)
        entries.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": f"{JAX_KERNEL}:185", "launches": None,
                        "max_abs_err": max(errs), "ms": ms["8"], "ms_by_tile": ms,
                        "plain_ms": sample_entry["plain_ms"], "bound_ms": sample_entry["bound_ms"],
                        "bound_by": sample_entry["bound_by"],
                        "fraction_of_bound": sample_entry["bound_ms"] / ms["8"],
                        "library_ms": sample_entry["library_ms"], "served_path": served})
    try:
        fused_spectrogram(y[:6], grid="tile", batch_tile=4)
    except ValueError as e:
        print(json.dumps({"tile_grid_B6_tile4": f"ValueError: {e}"}))
    else:
        fail("grid='tile' at B=6, batch_tile 4 did not raise ValueError")
    return entries


def bench_phase(torch) -> dict[str, int]:
    """The frontend bench entry at B=BENCH_B on CUDA; returns its kernel
    launches, counted from zero."""
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.scripts import bench_frontend

    frontend_kernel.launches.clear()
    t0 = time.perf_counter()
    result = bench_frontend.run(BENCH_B)
    wall = time.perf_counter() - t0
    counts = dict(frontend_kernel.launches)
    for line in bench_frontend.report(result):
        print(line)
    print(json.dumps({"bench_frontend": result, "wall_s": wall, "kernel_launches": counts}))
    frontend, agreement = result["frontend"], result["e2e"]["agreement"]
    tiles = frontend["tile_grid"]
    if not result["numerics"]["max_abs"] <= 1e-5:
        fail(f"bench numerics: max |kernel - composition| {result['numerics']['max_abs']}")
    if not frontend["sample_grid_max_abs_diff"] <= 1e-5:
        fail(f"bench sample grid at B={BENCH_B}: max |diff| "
             f"{frontend['sample_grid_max_abs_diff']}")
    if sorted(tiles, key=int) != [str(t) for t in TILES]:
        fail(f"bench ran tiles {sorted(tiles)}, expected {TILES}")
    for tile, v in tiles.items():
        if not (v["finite"] and v["equals_sample_grid"] and v["max_abs_diff"] <= 1e-5):
            fail(f"bench tile {tile} at B={BENCH_B}: finite {v['finite']}, equal to the "
                 f"sample grid {v['equals_sample_grid']}, max |diff| {v['max_abs_diff']}")
    if not agreement["finite"]:
        fail("bench e2e: non-finite INT8 scores")
    # The repo's int8 gate (codes at most 1 apart, on under 1 %), and the
    # scores' agreement the codes allow.
    flips = agreement["entry_codes_differing"] / agreement["entry_codes"]
    if not (agreement["max_entry_code_diff"] <= 1 and flips < 0.01
            and agreement["min_cosine"] >= BENCH_MIN_COSINE):
        fail(f"bench e2e agreement: {agreement['entry_codes_differing']} entry codes differ "
             f"(max {agreement['max_entry_code_diff']}), min cosine "
             f"{agreement['min_cosine']} < {BENCH_MIN_COSINE}?")
    for grid in ("sample", "tile"):
        if not counts.get(frontend_kernel.kernel_name("linear", "none", grid=grid)):
            fail(f"bench: the {grid}-grid linear kernel never launched ({counts})")
    return counts


def requests_for(np, cfg, sizes):
    rng = np.random.default_rng(0)
    t = np.arange(cfg.chunk_samples) / cfg.sample_rate
    out = []
    for n in sizes:
        f0 = rng.uniform(500.0, 6000.0, (n, 1))
        chirp = 0.5 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.3 * t))
        out.append((chirp + rng.normal(0, 0.05, (n, t.size))).astype(np.float32))
    return out


def serve(torch, np, cfg, sizes, breakdown: bool) -> tuple[str, int]:
    """Serve `cfg` on CUDA and check it; returns (kernel name, its launches)."""
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        make_fused_classifier,
    )
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    mode = frontend_kernel.FRONTEND_MODES[cfg.audio_frontend]
    name = frontend_kernel.kernel_name(mode, cfg.mag_scale if mode == "mel" else "none")
    label = f"{cfg.audio_frontend}+{cfg.mag_scale}"
    model = init_model(build_dscnn(cfg, device="cuda"), seed=0)
    classify = make_fused_classifier(TorchRunner(model, cfg, device="cuda"), cfg,
                                     device="cuda")
    requests = requests_for(np, cfg, sizes)

    frontend_kernel.launches.clear()
    t0 = time.perf_counter()
    results = [classify_in_batches(classify, r, batch_size=B) for r in requests]
    wall = time.perf_counter() - t0
    launches = frontend_kernel.launches[name]
    others = frontend_kernel.launches.total() - launches
    n_batches = sum(-(-n // B) for n in sizes)

    scores = np.concatenate([s for s, _ in results])
    n_chunks = sum(sizes)
    print(json.dumps({"config": label, "kernel": name, "served_chunks": n_chunks,
                      "batches": n_batches, "kernel_launches": launches,
                      "serve_wall_s": wall, "chunks_per_s_incl_first_call": n_chunks / wall,
                      "request_seconds": [dt for _, dt in results],
                      "top1_mean": float(scores.max(axis=1).mean())}))
    if launches != n_batches or launches == 0 or others:
        fail(f"{label}: {name} launched {launches} times for {n_batches} batches "
             f"({others} other launches)")
    if scores.shape != (n_chunks, cfg.num_classes):
        fail(f"{label}: scores shape {scores.shape} != {(n_chunks, cfg.num_classes)}")
    if not np.isfinite(scores).all():
        fail(f"{label}: non-finite scores")
    row_err = float(np.abs(scores.sum(axis=1) - 1.0).max())
    if not row_err <= 1e-5:
        fail(f"{label}: score rows sum to 1 only within {row_err}")

    if breakdown:
        # Where one warm 64-chunk batch spends its time (CUDA events; the
        # launches these add come after the count above was read).
        runner = TorchRunner(model, cfg, device="cuda")
        wave = torch.from_numpy(requests[0])
        x = wave.cuda()
        with torch.no_grad():
            feats = frontend_kernel.frontend_input(x, cfg)
            print(json.dumps({"config": label, "batch_breakdown_ms": {
                "h2d_copy": cuda_ms(torch, lambda: wave.cuda()),
                "frontend_kernel": cuda_ms(torch, lambda: frontend_kernel.frontend_input(x, cfg)),
                "dscnn_forward": cuda_ms(torch, lambda: runner.forward(feats)),
                "classify_total": cuda_ms(torch, lambda: classify(requests[0])),
            }}))

    cpu_model = build_dscnn(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_classify = make_fused_classifier(TorchRunner(cpu_model, cfg, device="cpu"), cfg,
                                         device="cpu")
    cpu_err = float(np.abs(cpu_classify(requests[0]) - scores[:B]).max())
    print(json.dumps({"config": label, "cuda_vs_cpu_max_abs": cpu_err,
                      "row_sum_max_err": row_err}))
    if not cpu_err <= 1e-4:
        fail(f"{label}: CUDA vs CPU scores differ by {cpu_err} > 1e-4")
    return name, launches


def slice_phase(torch, np) -> dict[str, int]:
    """Serve every config of SERVED; returns {kernel name: launches}."""
    from birdnet_stm32_tpu_torch.config import ModelConfig

    flagship = ModelConfig.load(ROOT / "artifacts/flagship/bundle/model_config.json")
    launches = {}
    for frontend, mag, sizes in SERVED:
        cfg = dataclasses.replace(flagship, audio_frontend=frontend,
                                  mag_scale=mag or flagship.mag_scale)
        name, n = serve(torch, np, cfg, sizes, breakdown=len(sizes) > 1)
        launches[name] = n
    return launches


def device_activity(torch, fn) -> dict:
    """The CUDA kernels, copies and memsets one call of fn() puts on the
    card, and the sum of their device times (ms), by torch.profiler; both
    None when the profiler sees no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except RuntimeError as e:  # counts only: the checks do not depend on them
        print(json.dumps({"device_activity_not_measured": str(e)}))
        events = []
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return {"cuda_launches": len(events) or None, "device_busy_ms": busy if events else None}


def int8_phase(torch, np, flagship_cfg) -> dict[str, int]:
    """The INT8 leg, (a)-(d) of the module docstring; returns the int8
    kernel launches of the fused leg."""
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        make_fused_classifier,
    )
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.quant.tflite_import import build_executor
    from tests.int8_fixture import entry_transpose_fixture, flagship_features

    cfg = flagship_cfg
    requests = requests_for(np, cfg, REQUESTS)
    n_chunks, n_batches = sum(REQUESTS), sum(-(-n // B) for n in REQUESTS)
    flagship = TFLiteSimRunner(FLAGSHIP_TFLITE, device="cuda")
    fixture = TFLiteSimRunner(entry_transpose_fixture(flagship.graph), device="cuda")
    legs = {}
    for leg, runner, fused in (("flagship", flagship, False), ("fixture", fixture, True)):
        classify = make_fused_classifier(runner, cfg, device="cuda")
        if (classify.entry_quant is not None) != fused:
            fail(f"INT8 {leg}: fused entry {classify.entry_quant}, expected fused={fused}")
        frontend_kernel.launches.clear()
        t0 = time.perf_counter()
        results = [classify_in_batches(classify, r, batch_size=B) for r in requests]
        wall = time.perf_counter() - t0
        counts = dict(frontend_kernel.launches)
        scores = np.concatenate([sc for sc, _ in results])
        name = frontend_kernel.kernel_name("linear", "none", quant=fused)
        print(json.dumps({"int8_leg": leg, "fused_entry": fused, "served_chunks": n_chunks,
                          "batches": n_batches, "kernel_launches": counts,
                          "serve_wall_s": wall,
                          "chunks_per_s_incl_first_call": n_chunks / wall,
                          "request_seconds": [dt for _, dt in results],
                          "top1_mean": float(scores.max(axis=1).mean())}))
        if counts.get(name, 0) != n_batches or sum(counts.values()) != n_batches:
            fail(f"INT8 {leg}: launches {counts}, expected {name} x {n_batches} only")
        if scores.shape != (n_chunks, cfg.num_classes) or not np.isfinite(scores).all():
            fail(f"INT8 {leg}: scores {scores.shape} not finite [{n_chunks}, {cfg.num_classes}]")
        if scores.min() < 0.0 or scores.max() > 1.0:
            fail(f"INT8 {leg}: scores outside [0, 1]")
        legs[leg] = (classify, runner, scores, counts.get(name, 0))

    # (a) one batch: CUDA executor vs the port's CPU executor, same features.
    x = torch.from_numpy(requests[0]).cuda()
    with torch.no_grad():
        feats = frontend_kernel.frontend_input(x, cfg)
    cpu_scores = build_executor(flagship.graph, B, device="cpu")(feats.cpu()).numpy()
    a_scores, b_scores = legs["flagship"][2], legs["fixture"][2]
    checks = {"a_cuda_vs_cpu_executor_bit_equal": bool(np.array_equal(cpu_scores, a_scores[:B])),
              "b_fused_vs_flagship_bit_equal": bool(np.array_equal(a_scores, b_scores))}
    # (c) the golden's features through the CUDA executor.
    golden = np.load(INT8_GOLDEN)["scores"]
    got = build_executor(flagship.graph, 8, device="cuda")(
        torch.from_numpy(flagship_features(8)).cuda()).cpu().numpy()
    checks["c_golden_bit_equal"] = bool(np.array_equal(got, golden))
    print(json.dumps({"int8_checks": checks,
                      "a_max_abs_cuda_vs_cpu": float(np.abs(cpu_scores - a_scores[:B]).max()),
                      "b_max_abs_fused_vs_flagship": float(np.abs(a_scores - b_scores).max()),
                      "c_max_abs_vs_golden": float(np.abs(got - golden).max())}))
    for check, ok in checks.items():
        if not ok:
            fail(f"INT8 check {check} failed")

    # (d) one warm 64-chunk batch of each leg by part (CUDA events), and
    # what its executor puts on the card (profiler).
    wave = torch.from_numpy(requests[0])
    for leg, (classify, runner, _, _) in legs.items():
        quant = classify.entry_quant
        fwd = runner.executor(B, prequantized_input=quant is not None)
        with torch.no_grad():
            feats = frontend_kernel.frontend_input(x, cfg, quant=quant)
            print(json.dumps({"int8_leg": leg, "batch_breakdown_ms": {
                "h2d_copy": cuda_ms(torch, lambda: wave.cuda()),
                "frontend_kernel": cuda_ms(torch, lambda: frontend_kernel.frontend_input(
                    x, cfg, quant=quant)),
                "executor": cuda_ms(torch, lambda: fwd(feats)),
                "classify_total": cuda_ms(torch, lambda: classify(requests[0])),
            }, "executor_per_batch": device_activity(torch, lambda: fwd(feats))}))
    name = frontend_kernel.kernel_name("linear", "none", quant=True)
    return {name: legs["fixture"][3]}


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))

    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, entry_quant_params
    from tests.int8_fixture import entry_transpose_fixture

    build_phase()
    occupancy_phase()
    quant = entry_quant_params(entry_transpose_fixture(TFLiteGraph(FLAGSHIP_TFLITE)))
    entries = kernel_phase(torch, np, quant)
    sweep_phase(torch)
    launches = slice_phase(torch, np)
    flagship = ModelConfig.load(ROOT / "artifacts/flagship/bundle/model_config.json")
    launches.update(int8_phase(torch, np, flagship))
    tile_entries = tile_phase(torch, np, quant, entries)
    bench_launches = bench_phase(torch)
    for entry in entries:
        entry["launches"] = launches.get(entry["name"], 0)
    for entry in tile_entries:
        entry["launches"] = bench_launches.get(entry["name"], 0)
    entries += tile_entries
    for entry in entries:
        if entry["launches"] == 0 and entry["served_path"] is not None:
            fail(f"{entry['name']} was never launched on its served path")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"kernels": entries}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
