"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `ops/csrc/<name>.cu` has a plain C interface and is compiled on first
use into `build/torch_kernels/<name>-<digest>.so` at the repository root
(the digest covers the source and the flags, so an edited source rebuilds).
There is no fallback: without nvcc, or when a build fails, this raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("frontend_kernel", "int8_conv_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the port's CUDA "
                       "kernels are built from source on first use")


def library_path(name: str) -> Path:
    """Where `name`'s shared library lives once built."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library among `names`, one nvcc run each.

    Returns {name: seconds its nvcc took} for the ones built now. The
    compiler's output (with -Xptxas -v: registers, shared memory, spills)
    is kept beside each library as `<name>-<digest>.log`.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.parent / f"{so.name}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              check=False)
        seconds[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: {name} (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, so)
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for `name`, compiling it first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
