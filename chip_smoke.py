"""Smoke test of the PyTorch/CUDA port (birdnet_stm32_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA device (an H100):

    python3 chip_smoke.py

It imports nothing of JAX. In order it:

1. turns TF32 off for matmuls and cuDNN;
2. builds every CUDA kernel of the port from ops/csrc/ with nvcc and
   prints the build seconds and the compiler's register/spill report;
3. kernel phase: at the flagship geometry (B=64, T=66150, n_fft 512, hop
   258, 256 frames) holds the fused frontend kernel against its plain
   PyTorch version on the card (max abs <= 1e-5) and times kernel, plain
   version and the torch.stft yardstick with CUDA events;
4. slice phase: loads artifacts/flagship/bundle/model_config.json, gives
   the full-width DS-CNN seeded weights, and serves three requests of 64
   chunks and one ragged request of 37 through make_fused_classifier +
   classify_in_batches on CUDA. Checks: scores [N, 100], finite, rows sum
   to 1 within 1e-5, the kernel's launch count rose by the number of
   batches, and one batch's scores match the same port run on the CPU
   (plain frontend, same weights) within 1e-4. It also times one warm
   64-chunk batch by part: host-to-device copy, frontend, DS-CNN, whole;
5. prints the `kernels` JSON line, the card's name and power limit, and
   last the `ok` JSON line.

Any failed check exits non-zero before the `ok` line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, T, N_FFT, SPEC_WIDTH = 64, 66150, 512, 256
REQUESTS = (64, 64, 64, 37)
FP32_PEAK_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12


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


def build_phase() -> None:
    from birdnet_stm32_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    print(json.dumps({"build_seconds": round(time.perf_counter() - t0, 3),
                      "nvcc_seconds": {k: round(v, 3) for k, v in per_source.items()}}))
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")


def kernel_phase(torch) -> dict:
    from birdnet_stm32_tpu_torch.device import full_fp32
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
        fused_spectrogram,
        fused_spectrogram_plain,
    )

    hop = T // SPEC_WIDTH
    n_bins = N_FFT // 2 + 1
    g = torch.Generator(device="cuda").manual_seed(0)
    y = 0.5 * torch.randn(B, T, generator=g, device="cuda")

    def kernel():
        return fused_spectrogram(y, n_fft=N_FFT, spec_width=SPEC_WIDTH)

    def plain():
        return fused_spectrogram_plain(y, N_FFT, hop, SPEC_WIDTH)

    window = torch.hann_window(N_FFT, periodic=True, device="cuda")

    def library():
        S = torch.stft(y, N_FFT, hop_length=hop, window=window, center=True,
                       pad_mode="constant", return_complex=True).abs()[..., :SPEC_WIDTH]
        s_min = S.amin(dim=(1, 2), keepdim=True)
        s_max = S.amax(dim=(1, 2), keepdim=True)
        return (S - s_min) / (s_max - s_min + 1e-10)

    with full_fp32():
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        lib = library()
        torch.cuda.synchronize()
        if got.shape != (B, n_bins, SPEC_WIDTH) or not torch.isfinite(got).all():
            fail(f"kernel output {tuple(got.shape)} not finite [B, F, W]")
        err = (got - ref).abs().max().item()
        print(json.dumps({"kernel": "fused_spectrogram_linear", "max_abs_vs_plain": err,
                          "max_abs_vs_torch_stft": (got - lib).abs().max().item()}))
        if not err <= 1e-5:
            fail(f"fused_spectrogram kernel vs plain: max abs {err} > 1e-5")
        ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain)
        library_ms = cuda_ms(torch, library)
        # The kernel resets its arrival counters itself: after the timed
        # launches it must still normalise every sample.
        err_after = (kernel() - ref).abs().max().item()
        if not err_after <= 1e-5:
            fail(f"fused_spectrogram kernel after the timing launches: max abs "
                 f"{err_after} > 1e-5 (arrival counters not reset?)")
        err = max(err, err_after)

    # Least time for the same function, whatever the algorithm: each
    # waveform sample read once and each feature written once, against the
    # operations of the FFT route per frame (real-input FFT ~2.5 n log2 n,
    # the window, |.| = 2 mul + add + sqrt, min and max, subtract and
    # divide). The kernel's own DFT-as-matmul does ~40x these operations.
    fft_ops = 2.5 * N_FFT * math.log2(N_FFT) + N_FFT + n_bins * (4 + 2 + 2)
    flops = B * SPEC_WIDTH * fft_ops
    n_bytes = 4.0 * (B * T + B * n_bins * SPEC_WIDTH)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return {"name": "fused_spectrogram_linear", "route": "cuda",
            "source": "birdnet_stm32_tpu_torch/ops/csrc/frontend_kernel.cu",
            "replaces": "birdnet_stm32_tpu/ops/pallas/frontend_kernel.py:154",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def slice_phase(torch, np) -> int:
    """Serve the flagship config on CUDA; returns the kernel launches counted."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        make_fused_classifier,
    )
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    cfg = ModelConfig.load(ROOT / "artifacts/flagship/bundle/model_config.json")
    model = init_model(build_dscnn(cfg, device="cuda"), seed=0)
    classify = make_fused_classifier(TorchRunner(model, cfg, device="cuda"), cfg,
                                     device="cuda")
    rng = np.random.default_rng(0)
    t = np.arange(cfg.chunk_samples) / cfg.sample_rate
    requests = []
    for n in REQUESTS:
        f0 = rng.uniform(500.0, 6000.0, (n, 1))
        chirp = 0.5 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.3 * t))
        requests.append((chirp + rng.normal(0, 0.05, (n, t.size))).astype(np.float32))

    frontend_kernel.launches = 0
    t0 = time.perf_counter()
    results = [classify_in_batches(classify, r, batch_size=B) for r in requests]
    wall = time.perf_counter() - t0
    launches = frontend_kernel.launches
    n_batches = sum(-(-n // B) for n in REQUESTS)

    scores = np.concatenate([s for s, _ in results])
    n_chunks = sum(REQUESTS)
    print(json.dumps({"served_chunks": n_chunks, "batches": n_batches,
                      "kernel_launches": launches, "serve_wall_s": wall,
                      "chunks_per_s_incl_first_call": n_chunks / wall,
                      "request_seconds": [dt for _, dt in results],
                      "top1_mean": float(scores.max(axis=1).mean())}))
    if launches != n_batches or launches == 0:
        fail(f"fused frontend kernel launched {launches} times for {n_batches} batches")
    if scores.shape != (n_chunks, cfg.num_classes):
        fail(f"scores shape {scores.shape} != {(n_chunks, cfg.num_classes)}")
    if not np.isfinite(scores).all():
        fail("non-finite scores")
    row_err = float(np.abs(scores.sum(axis=1) - 1.0).max())
    if not row_err <= 1e-5:
        fail(f"score rows sum to 1 only within {row_err}")

    # Where one warm 64-chunk batch spends its time (CUDA events; the
    # launches these add come after the count above was read).
    runner = TorchRunner(model, cfg, device="cuda")
    wave = torch.from_numpy(requests[0])
    x = wave.cuda()
    with torch.no_grad():
        feats = frontend_kernel.frontend_input(x, cfg)
        print(json.dumps({"batch_breakdown_ms": {
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
    print(json.dumps({"cuda_vs_cpu_max_abs": cpu_err, "row_sum_max_err": row_err}))
    if not cpu_err <= 1e-4:
        fail(f"CUDA vs CPU scores differ by {cpu_err} > 1e-4")
    return launches


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))

    build_phase()
    entry = kernel_phase(torch)
    entry["launches"] = slice_phase(torch, np)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"kernels": [entry]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
