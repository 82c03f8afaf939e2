"""Times variants of the fused frontend kernels against each other on a GPU.

    python -m birdnet_stm32_tpu_torch.scripts.kernel_variants [SOURCE.cu ...]

Builds ops/csrc/frontend_kernel.cu as it is ("as_is"), the same source with
the per-sample tail skipped ("no_tail": no block is ever last to arrive, so
no normalisation pass, no epilogue and no arrival counting; the output is
not normalised), and each SOURCE.cu given, all with the repository's nvcc
flags and in parallel. Then it times every kernel-phase specialisation of
chip_smoke.py (B=64, T=66150, n_fft 512, 256 frames, 64 mels) with each
library in turns, first to last and back (A, B, .., B, A), by CUDA events,
and prints one JSON line: {spec: {variant: [ms, ms]}}. as_is minus no_tail
is the tail's share of a kernel. Needs a CUDA device; builds go to
build/kernel_variants/ at the repository root.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from birdnet_stm32_tpu_torch.ops.kernels import _build
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel as fk

OUT_DIR = _build.BUILD_DIR.parent / "kernel_variants"
B, T = 64, 66150
SPECS = (("linear", "none", False), ("mel", "none", False), ("mel", "pwl", False),
         ("mel", "db", False), ("mel", "pcen", False), ("log_mel", "none", False),
         ("mfcc", "none", False), ("linear", "none", True), ("mel", "pwl", True))
QUANT = (0.00392156932502985, -128)
# The call whose result decides whether a strip's block runs a sample's tail.
_ARRIVAL = "if (!last_to_arrive("


def no_tail_source(src: str) -> str:
    """`src` with both kernels' tails skipped: every block takes the
    `continue` after its arrival check without arriving."""
    if src.count(_ARRIVAL) != 2:
        raise ValueError(f"expected the two kernels' arrival checks, found {src.count(_ARRIVAL)}")
    return src.replace(_ARRIVAL, "if (true || !last_to_arrive(")


def build(variants: dict[str, Path]) -> dict[str, Path]:
    """Compiles each variant's source into OUT_DIR in parallel; {name: .so}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                     str(OUT_DIR / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in variants.items()}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: OUT_DIR / f"{name}.so" for name in variants}


def use(library: Path) -> None:
    """Makes the kernel wrapper load `library`."""
    fk._lib.cache_clear()
    _build.load = lambda name: ctypes.CDLL(str(library))
    fk._lib()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA device")
    source = _build.CSRC_DIR / "frontend_kernel.cu"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    no_tail = OUT_DIR / "no_tail.cu"
    no_tail.write_text(no_tail_source(source.read_text()))
    variants = {"as_is": source, "no_tail": no_tail}
    variants.update({Path(a).stem: Path(a) for a in argv})
    libraries = build(variants)
    y = 0.5 * torch.randn(B, T, generator=torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    times: dict[str, dict[str, list[float]]] = {}
    names = list(libraries)
    for name in names + names[::-1]:
        use(libraries[name])
        for mode, mag, int8 in SPECS:
            def kernel(mode=mode, mag=mag, int8=int8):
                return fk.fused_spectrogram(y, mode=mode, mag_scale=mag,
                                            quant=QUANT if int8 else None)

            spec = fk.kernel_name(mode, mag, int8)
            times.setdefault(spec, {}).setdefault(name, []).append(cuda_ms(kernel))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "B": B, "ms": times}))


if __name__ == "__main__":
    main(sys.argv[1:])
