"""Serve CLI: directory-watching classification service (port of cli/serve.py).

New WAVs in the watched directory are picked up every poll interval,
classified through the fused device dispatch (models/serving.py), pooled
per file by the mean, and appended to the results file in the firmware's
TSV schema: the path relative to the watched directory, then every class
score at 4 decimals. Files already in the results file are skipped on
restart, so the service resumes where it stopped.

The port adds `--device` (default cuda; nothing falls back to the CPU on
its own). It serves .tflite models, the run directories the port's
`train` writes and reference .keras archives (float32, or bf16 with
`--bf16`; models/runners.py::load_model_runner).
With a .tflite `--bf16` is accepted and ignored, as in the JAX package,
and the lines served are the same as without it.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(
        "birdnet_stm32_tpu_torch serve",
        description="Watch a directory and classify new WAVs continuously.")
    p.add_argument("--model_path", required=True,
                   help=".tflite model or a run directory of train")
    p.add_argument("--audio_dir", required=True, help="directory to watch")
    p.add_argument("--config_path", default=None)
    p.add_argument("--labels_path", default=None)
    p.add_argument("--results_file", default=None,
                   help="TSV results path (default: <audio_dir>/results.txt)")
    p.add_argument("--poll_interval", type=float, default=2.0,
                   help="seconds between directory scans")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--top_k", type=int, default=3)
    p.add_argument("--score_threshold", type=float, default=0.01)
    p.add_argument("--thresholds", default=None, metavar="JSON",
                   help="per-class thresholds file ({class: threshold}); classes "
                        "absent from the file use --score_threshold")
    p.add_argument("--chunk_overlap", type=float, default=0.0)
    p.add_argument("--bf16", action="store_true",
                   help="serve float checkpoints in bfloat16 (a .tflite ignores it)")
    p.add_argument("--device_resample", action="store_true",
                   help="decode at native rate, resample on the device")
    p.add_argument("--int16_io", action="store_true",
                   help="ship waveforms to the device as int16 PCM codes (half the "
                        "host-to-device bytes); bit-exact against the float path for "
                        "mono PCM16 WAVs at the model rate, ~1 LSB error otherwise")
    p.add_argument("--ulaw_io", action="store_true",
                   help="ship waveforms as int8 mu-law codes (a quarter of the float32 "
                        "bytes; ~2.2%% relative companding error, not bit-exact)")
    p.add_argument("--decode_threads", type=int, default=0,
                   help="decode N files ahead on threads (0 = serial)")
    p.add_argument("--once", action="store_true",
                   help="process the current directory contents and exit")
    p.add_argument("--device", default="cuda",
                   help="device for ingress, frontend and model (default cuda; "
                        "raises without one; pass cpu for the CPU)")
    return p.parse_args(argv)


def _recorded_files(results_file: Path) -> set[str]:
    """First column of an existing results TSV (resume support)."""
    if not results_file.exists():
        return set()
    return {line.split("\t", 1)[0]
            for line in results_file.read_text().splitlines() if line}


def _append_result(results_file: Path, name: str, scores: np.ndarray) -> None:
    """One TSV line: filename then every class score at 4 decimals."""
    with open(results_file, "a") as f:
        f.write(name + "".join(f"\t{s:.4f}" for s in scores) + "\n")


def serve_loop(runner, cfg, classes, audio_dir: Path, results_file: Path,
               poll_interval: float = 2.0, batch_size: int = 64, top_k: int = 3,
               score_threshold: float = 0.01, overlap: float = 0.0,
               device_resample: bool = False, once: bool = False,
               max_polls: int | None = None, decode_threads: int = 0,
               int16_io: bool = False, ulaw_io: bool = False,
               device: str = "cuda") -> int:
    """Watch `audio_dir`; classify and record new files. Returns files served.

    With decode_threads > 0 the next files decode on host threads while
    the device classifies the current one. Results stay in directory order
    either way.
    """
    from birdnet_stm32_tpu_torch.data.dataset import supported_audio_extensions
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        decode_for_classify,
        make_classifier_cache,
        top_predictions,
    )

    classifier_for = make_classifier_cache(
        runner, cfg, input_dtype="int16" if int16_io else ("ulaw" if ulaw_io else None),
        device=device)
    exts = supported_audio_extensions()

    done = _recorded_files(results_file)
    if done:
        print(f"[serve] resuming: {len(done)} files already in {results_file.name}")
    print(f"[serve] watching {audio_dir} (poll {poll_interval:.1f}s); "
          f"results -> {results_file}")

    def decode(path: Path):
        """(rel, chunks, src_rate, error); runs on a worker thread when
        decode_threads > 0, so it touches no shared state."""
        rel = str(path.relative_to(audio_dir))
        try:
            chunks, src_rate, _dur, _ms = decode_for_classify(
                path, cfg, overlap, max_duration=None, device_resample=device_resample,
                int16_io=int16_io, ulaw_io=ulaw_io)
        except Exception as e:  # one bad file must not stop the service
            return rel, None, cfg.sample_rate, e
        return rel, chunks, src_rate, None

    def bounded_decode(pool, paths, window):
        """Decode ahead through a bounded sliding window, in order: a whole
        backlog at once would hold every decoded waveform in memory."""
        it = iter(paths)
        # range first: zip pulls left to right, so `it` must be second or
        # the (window+1)th path is consumed and lost.
        q = deque(pool.submit(decode, p) for _, p in zip(range(window), it))
        while q:
            yield q.popleft().result()
            for p in it:
                q.append(pool.submit(decode, p))
                break

    served = 0
    polls = 0
    pending: dict[str, int] = {}  # rel -> size at last poll (copy-in-progress guard)
    pool = (ThreadPoolExecutor(max_workers=decode_threads, thread_name_prefix="serve-decode")
            if decode_threads > 0 else None)
    try:
        while True:
            new = sorted(p for p in audio_dir.rglob("*")
                         if p.suffix.lower() in exts
                         and str(p.relative_to(audio_dir)) not in done)
            live = {str(p.relative_to(audio_dir)) for p in new}
            for gone in [r for r in pending if r not in live]:
                del pending[gone]
            ready = []
            for path in new:
                # Keyed by the path relative to the watched directory: bare
                # file names collide across class subfolders.
                rel = str(path.relative_to(audio_dir))
                # A file still being copied in waits until its size is the
                # same at two polls (not in --once mode, where the caller
                # says the directory is complete).
                if not once:
                    try:
                        size = path.stat().st_size
                    except OSError:
                        continue
                    if pending.get(rel) != size:
                        pending[rel] = size
                        continue
                    pending.pop(rel, None)
                ready.append(path)
            decoded = (bounded_decode(pool, ready, max(2 * decode_threads, 4))
                       if pool is not None else (decode(p) for p in ready))
            for rel, chunks, src_rate, err in decoded:
                t0 = time.perf_counter()
                if err is not None:
                    print(f"[serve] {rel}: decode failed ({err}); skipped")
                    done.add(rel)
                    continue
                if chunks.shape[0] == 0:
                    print(f"[serve] {rel}: no audio; skipped")
                    done.add(rel)
                    continue
                scores, _ = classify_in_batches(classifier_for(src_rate), chunks, batch_size)
                pooled = scores.mean(axis=0)
                _append_result(results_file, rel, pooled)
                done.add(rel)
                served += 1
                top = top_predictions(pooled, top_k, score_threshold)
                preds = ", ".join(f"{classes[i]} ({pooled[i]:.3f})" for i in top)
                dt = (time.perf_counter() - t0) * 1000.0
                print(f"file: {rel}  chunks: {len(chunks)}  top: {preds}  [{dt:.0f} ms]")
            polls += 1
            if once or (max_polls is not None and polls >= max_polls):
                break
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        print("\n[serve] interrupted")
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
    print(f"=== DONE ===\nfiles served: {served}  results: {results_file}")
    return served


def main(argv=None) -> int:
    args = get_args(argv)

    import torch

    from birdnet_stm32_tpu_torch.cli.benchmark import _resolve_classes
    from birdnet_stm32_tpu_torch.cli.deploy import resolve_config_path
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.data.species import open_species_list
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner

    if args.int16_io and args.ulaw_io:
        raise SystemExit("--int16_io and --ulaw_io are mutually exclusive")
    # --bf16 serves a float checkpoint in bfloat16; a .tflite ignores it
    # (load_model_runner), as in the JAX package.
    dtype = torch.bfloat16 if args.bf16 else None
    device = resolve_device(args.device)
    config_path = resolve_config_path(args.model_path, args.config_path)
    runner = load_model_runner(Path(args.model_path), dtype=dtype, device=device,
                               config_path=config_path)
    if config_path is None:
        raise SystemExit("--config_path required for .tflite models (no "
                         f"model_config.json sidecar found next to {args.model_path})")
    cfg = ModelConfig.load(config_path)
    classes = _resolve_classes(
        open_species_list(args.labels_path) if args.labels_path else cfg.class_names, cfg)

    audio_dir = Path(args.audio_dir)
    if not audio_dir.is_dir():
        raise SystemExit(f"audio_dir not found: {audio_dir}")
    results_file = (Path(args.results_file) if args.results_file
                    else audio_dir / "results.txt")

    score_threshold = args.score_threshold
    if args.thresholds:
        # Per-class operating point over the serving class order; absent
        # classes keep the flat --score_threshold.
        th = json.loads(Path(args.thresholds).read_text())
        unknown = sorted(set(th) - set(classes))
        if unknown:
            raise SystemExit(
                f"--thresholds names classes the model doesn't serve: "
                f"{unknown[:5]}{'...' if len(unknown) > 5 else ''}")
        # A labels file may be longer than the model's output: the vector
        # must match the score width.
        served = classes[: cfg.num_classes] if cfg.num_classes else classes
        score_threshold = np.array([float(th.get(c, args.score_threshold)) for c in served],
                                   np.float32)

    serve_loop(runner, cfg, classes, audio_dir, results_file,
               poll_interval=args.poll_interval, batch_size=args.batch_size,
               top_k=args.top_k, score_threshold=score_threshold,
               overlap=args.chunk_overlap, device_resample=args.device_resample,
               once=args.once, decode_threads=args.decode_threads,
               int16_io=args.int16_io, ulaw_io=args.ulaw_io, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
