"""Frontend benchmark of the port (port of scripts/bench_pallas_frontend.py).

Holds the fused frontend kernel (ops/kernels/frontend_kernel.py, hand-written
CUDA) against the plain PyTorch composition (ops/frontend.py::
inputs_for_config, TF32 off) at the geometry of the flagship bundle
(artifacts/flagship/bundle: hybrid frontend, T=66150, n_fft 512, hop 258,
256 frames), three ways:

1. numerics: max, mean and share > 1e-6 of |kernel - composition| on the
   [B, 257, 256, 1] features of N_CHECK = 32 chunks;
2. frontend: sustained chunks/s of the composition, the kernel's sample
   grid and its tile grid at batch_tile 2, 4, 8 and 16 (each that divides
   B); on the timed [B, T] input itself, each grid's max |diff| against the
   composition, and whether each tile's features equal the sample grid's
   bit for bit;
3. end-to-end INT8: the bit-exact integer executor on the bundle's
   model_quantized.tflite, fed by the composition and by the sample-grid
   kernel: sustained chunks/s, and on the 32 chunks whether their scores
   agree (identical, min cosine, max |dscore|) and how many of the graph's
   entry codes (its QUANTIZE of the features) differ between the feeds.

Nothing falls back: a kernel that fails to build or launch raises, and the
script exits non-zero.

Usage, from the repository root on a machine with a CUDA device:

    python -m birdnet_stm32_tpu_torch.scripts.bench_frontend [B]

B defaults to 2048. It prints one line per measurement and, last, the
whole result as one JSON object. `run(B, device="cpu")` runs the same
sections on the CPU through the kernels' plain versions (the tests do);
its rates are the CPU's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import fused_hybrid_frontend
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    TFLiteGraph,
    build_executor,
    f32_reciprocal,
    quantize_f32,
)
from birdnet_stm32_tpu_torch.utils.benchmarking import sustained_chunks_per_sec

BUNDLE = Path(__file__).resolve().parents[2] / "artifacts" / "flagship" / "bundle"
N_CHECK = 32
TILES = (2, 4, 8, 16)


@torch.no_grad()
def run(B: int = 2048, device: str | torch.device = "cuda", iters: int = 20,
        reps: int = 3) -> dict:
    """The three sections at batch B on `device`, as a dict: "numerics",
    "frontend" (chunks/s; the sample grid's and each tile's max |diff| on
    the timed input; per tile also whether its features are finite and
    equal the sample grid's) and "e2e" (chunks/s and "agreement")."""
    dev = resolve_device(device)
    cfg = ModelConfig.load(BUNDLE / "model_config.json")
    T, n_fft = cfg.chunk_samples, cfg.fft_length
    hop = max(1, T // cfg.spec_width)
    n_frames = min(cfg.spec_width, 1 + T // hop)
    rng = np.random.default_rng(0)
    small = torch.from_numpy(rng.normal(size=(N_CHECK, T)).astype(np.float32)).to(dev)
    wave = torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32)).to(dev)

    def kernel(w, grid="sample", tile=8):
        return fused_hybrid_frontend(w, n_fft, hop, n_frames, batch_tile=tile, grid=grid)[..., None]

    def rate(fn):
        return sustained_chunks_per_sec(fn, wave, iters=iters, reps=reps)

    result = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "config": {"bundle": str(BUNDLE), "T": T, "n_fft": n_fft, "hop": hop,
                         "W": n_frames, "B": B, "iters": iters, "reps": reps}}
    with full_fp32():
        ref = inputs_for_config(small, cfg)
        feats = kernel(small)
        d = (feats - ref).abs()
        result["numerics"] = {"B": N_CHECK, "max_abs": d.max().item(),
                              "mean_abs": d.mean().item(),
                              "frac_gt_1e-6": (d > 1e-6).float().mean().item()}

        # Every grid is checked on the [B, T] input it is timed on.
        ref_b, sample = inputs_for_config(wave, cfg), kernel(wave)
        frontend = {"composition": rate(lambda w: inputs_for_config(w, cfg).sum()),
                    "sample_grid": rate(lambda w: kernel(w).sum()),
                    "sample_grid_max_abs_diff": (sample - ref_b).abs().max().item(),
                    "tile_grid": {}}
        for tile in TILES:
            if B % tile:
                continue
            got = kernel(wave, "tile", tile)
            frontend["tile_grid"][str(tile)] = {
                "chunks_per_s": rate(lambda w, t=tile: kernel(w, "tile", t).sum()),
                "max_abs_diff": (got - ref_b).abs().max().item(),
                "equals_sample_grid": torch.equal(got, sample),
                "finite": bool(torch.isfinite(got).all())}
            del got
        result["frontend"] = frontend
        del ref_b, sample

        graph = TFLiteGraph(BUNDLE / "model_quantized.tflite")
        fwd = build_executor(graph, B, device=dev)
        e2e = {"composition": rate(lambda w: fwd(inputs_for_config(w, cfg)).sum()),
               "sample_grid": rate(lambda w: fwd(kernel(w)).sum())}
        # Score agreement on the 32 chunks: the executor is bit-exact given
        # the same codes, so this measures int8 rounding flips from the two
        # frontends' float32 summation orders; the flips themselves are
        # counted on the graph's entry QUANTIZE (op 0, on the input).
        fwd_check = build_executor(graph, N_CHECK, device=dev)
        a, b = fwd_check(ref), fwd_check(feats)
        cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1) + 1e-12)
        entry = graph.ops[0]
        if entry.name != "QUANTIZE" or entry.inputs[0] != graph.inputs[0]:
            raise ValueError("the INT8 graph does not start with QUANTIZE of its input")
        q = graph.tensors[entry.outputs[0]]
        inv, zp = f32_reciprocal(float(q.scale[0]), dev), int(q.zero_point[0])
        codes = (quantize_f32(feats, inv, zp).int() - quantize_f32(ref, inv, zp).int()).abs()
        e2e["agreement"] = {"B": N_CHECK, "identical": torch.equal(a, b),
                            "min_cosine": cos.min().item(),
                            "max_abs_dscore": (a - b).abs().max().item(),
                            "entry_codes": codes.numel(),
                            "entry_codes_differing": int((codes > 0).sum().item()),
                            "max_entry_code_diff": int(codes.max().item()),
                            "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all())}
        result["e2e"] = e2e
    return result


def report(result: dict) -> list[str]:
    """One line per measurement, in the JAX script's words."""
    def rate(r):
        return f"{r:,.0f} chunks/s ({1e6 / r:.1f} us/chunk)"

    c, n, f, e = result["config"], result["numerics"], result["frontend"], result["e2e"]
    lines = [f"[cfg] T={c['T']} n_fft={c['n_fft']} hop={c['hop']} W={c['W']} B={c['B']} "
             f"device={result['device']}",
             f"[numerics] max|diff|={n['max_abs']:.3e} mean={n['mean_abs']:.3e} "
             f"frac>1e-6={n['frac_gt_1e-6']:.2e}",
             f"[frontend] composition: {rate(f['composition'])}",
             f"[frontend] kernel sample grid: {rate(f['sample_grid'])} "
             f"max|diff|={f['sample_grid_max_abs_diff']:.3e}"]
    lines += [f"[frontend] kernel tile grid tile={t}: {rate(v['chunks_per_s'])} "
              f"max|diff|={v['max_abs_diff']:.3e} equals_sample_grid={v['equals_sample_grid']}"
              for t, v in f["tile_grid"].items()]
    a = e["agreement"]
    lines += [f"[e2e] INT8 + composition:    {rate(e['composition'])}",
              f"[e2e] INT8 + kernel frontend: {rate(e['sample_grid'])}",
              f"[e2e] score agreement: identical={a['identical']} "
              f"min_cosine={a['min_cosine']:.6f} max|dscore|={a['max_abs_dscore']:.3e} "
              f"entry codes differing={a['entry_codes_differing']}/{a['entry_codes']} "
              f"(max {a['max_entry_code_diff']})"]
    return lines


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    result = run(int(argv[0]) if argv else 2048)
    for line in report(result):
        print(line, flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
