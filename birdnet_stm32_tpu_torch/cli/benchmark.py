"""Benchmark CLI: the batched inference driver over a WAV directory (port
of cli/benchmark.py).

    python -m birdnet_stm32_tpu_torch benchmark --model_path M --audio_dir DIR [--device cpu]

It scans a directory for WAVs, decodes and chunks them on the host, runs
the fused ingress + frontend + model dispatch on the device, prints each
file's top-K predictions with a [BENCH] read / frontend / model / total
line, and ends with the `=== DONE ===` summary and the real-time factor:
the firmware's line protocol. `--pipeline N` decodes on N threads while
batches packed across files run on the device, at most `max_outstanding`
in flight, each drained with one copy to the host. `--trace_dir` writes a
torch.profiler Chrome trace. The port adds `--device` (default cuda).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser("birdnet_stm32_tpu_torch benchmark")
    p.add_argument("--model_path", required=True,
                   help=".tflite model or a run directory of train")
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--config_path", default=None)
    p.add_argument("--labels_path", default=None)
    p.add_argument("--top_k", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--chunk_overlap", type=float, default=0.0)
    p.add_argument("--csv", default=None, help="optional results CSV path")
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run into this "
                        "directory (view in Perfetto or chrome://tracing)")
    p.add_argument("--bf16", action="store_true",
                   help="serve float checkpoints in bfloat16; ignored for .tflite "
                        "artifacts")
    p.add_argument("--pipeline", type=int, default=0, metavar="N",
                   help="pipelined serving with N decode threads: decode "
                        "overlaps the device's queued batches (0 = serial "
                        "driver with per-file [BENCH] stage timings)")
    p.add_argument("--device_resample", action="store_true",
                   help="decode at each file's native rate and resample on "
                        "the device inside the fused dispatch (skips host "
                        "resampling)")
    p.add_argument("--int16_io", action="store_true",
                   help="ship waveforms to the device as int16 PCM codes "
                        "and dequantize there: half the host-to-device "
                        "bytes. Mono PCM16 WAVs at the model rate ship their "
                        "raw codes (scores bit-exact against the float path); "
                        "other sources requantize (one PCM16 LSB, ~3e-5)")
    p.add_argument("--ulaw_io", action="store_true",
                   help="ship waveforms as int8 mu-law codes: a quarter of "
                        "the float32 host-to-device bytes at ~2.2%% relative "
                        "waveform error (not bit-exact)")
    p.add_argument("--cache_dir", default=None,
                   help="decoded-waveform cache directory (audio/io."
                        "cached_waveform): the first pass decodes each file "
                        "once, later passes serve memmap slices")
    p.add_argument("--device", default="cuda",
                   help="device for ingress, frontend and model (default cuda; "
                        "raises without one; pass cpu for the CPU)")
    return p.parse_args(argv)


def _warmup(classify, n_samples, batch_size, dtype=np.float32) -> None:
    """One dummy batch before the clock starts: first-call set-up (the
    executor's build, cuDNN's algorithm search, the kernel module's load)
    is paid once per process, not per file."""
    t0 = time.perf_counter()
    np.asarray(classify(np.zeros((batch_size, n_samples), dtype)))
    dt = time.perf_counter() - t0
    if dt > 1.0:
        print(f"[info] warmup {dt:.1f} s (compile/load, excluded from timings)")


def _warmup_all_rates(classifier_for, cfg, batch_size, files, device_resample,
                      dtype=np.float32):
    """Warm every classifier the run will need BEFORE the clock starts.

    With --device_resample one classifier is made per distinct source
    rate; warming only cfg.sample_rate would put the first new rate's
    set-up inside that file's [BENCH] model time and the real-time factor.
    The header probes (one read per file) run outside the timed region."""
    rates = {cfg.sample_rate}
    if device_resample:
        from birdnet_stm32_tpu_torch.audio.io import audio_info

        for f in files:
            try:
                sr = int(audio_info(f).sample_rate)
                if sr > 0:
                    rates.add(sr)
            except Exception:
                pass
    for r in sorted(rates):
        # int16 shipping carries one trailing scale element per row.
        n = int(r * cfg.chunk_duration) + (1 if dtype == np.int16 else 0)
        _warmup(classifier_for(r), n, batch_size, dtype)


def run_benchmark(runner, cfg, classes, files, top_k=3, batch_size=64,
                  overlap=0.0, csv_path=None, score_threshold=0.0,
                  timeout=None, device_resample=False,
                  cache_dir=None, int16_io=False, ulaw_io=False,
                  device="cuda") -> dict:
    """Drive the batched inference loop and print the [BENCH] protocol.

    With device_resample=True, files are decoded at their native sample
    rate and polyphase-resampled on the device inside the fused dispatch
    (ops/resample.py), one classifier per distinct source rate.
    """
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        decode_for_classify,
        make_classifier_cache,
        top_predictions,
    )

    classifier_for = make_classifier_cache(
        runner, cfg, verbose=True,
        input_dtype="int16" if int16_io else ("ulaw" if ulaw_io else None),
        device=device)

    print("[info] frontend+model fused into one device dispatch; "
          "[BENCH] 'model' covers both, 'frontend' reads 0.0")
    _warmup_all_rates(classifier_for, cfg, batch_size, files, device_resample,
                      np.int16 if int16_io else (np.int8 if ulaw_io
                                                 else np.float32))

    per_file_rows = []
    t_read = t_frontend = t_model = 0.0
    total_chunks = 0
    audio_s = 0.0
    t_all0 = time.perf_counter()

    timed_out = False
    for path in files:
        if timeout is not None and time.perf_counter() - t_all0 > timeout:
            # The board test's capture timeout: stop and report what
            # finished.
            print(f"[WARN] timeout after {timeout:.0f} s; "
                  f"{len(per_file_rows)} of {len(files)} files processed")
            timed_out = True
            break
        # The whole file (evaluate caps at 60 s by default; the board-test
        # loop takes every chunk). One probe and one decode.
        chunks, src_rate, dur_s, read_ms = decode_for_classify(
            path, cfg, overlap, max_duration=None,
            device_resample=device_resample, cache_dir=cache_dir,
            int16_io=int16_io, ulaw_io=ulaw_io)
        if chunks.shape[0] == 0:
            print(f"file: {Path(path).name}  SKIP (no audio)")
            continue
        classify = classifier_for(src_rate)
        fe_s = 0.0
        scores, mdl_s = classify_in_batches(classify, chunks, batch_size)
        total_chunks += len(chunks)
        audio_s += dur_s
        pooled = scores.mean(axis=0)
        fe_ms, mdl_ms = fe_s * 1000.0, mdl_s * 1000.0
        total_ms = read_ms + fe_ms + mdl_ms
        t_read += read_ms
        t_frontend += fe_ms
        t_model += mdl_ms

        top = top_predictions(pooled, top_k, score_threshold)
        preds = ", ".join(f"{classes[i]} ({pooled[i]:.3f})" for i in top)
        print(f"file: {Path(path).name}  chunks: {len(chunks)}  top: {preds}")
        print(f"[BENCH] read: {read_ms:.1f} ms  frontend: {fe_ms:.1f} ms  "
              f"model: {mdl_ms:.1f} ms  total: {total_ms:.1f} ms")
        per_file_rows.append({
            "file": str(path), "chunks": len(chunks),
            "top1": classes[int(top[0])], "score": float(pooled[top[0]]),
            "read_ms": read_ms, "frontend_ms": fe_ms, "model_ms": mdl_ms,
        })

    wall_s = time.perf_counter() - t_all0
    n = max(1, len(per_file_rows))
    rtf = audio_s / wall_s if wall_s > 0 else float("inf")
    print("=== DONE ===")
    print(f"files: {len(per_file_rows)}  chunks: {total_chunks}")
    print(f"avg per file: read {t_read / n:.1f} ms, frontend {t_frontend / n:.1f} ms, "
          f"model {t_model / n:.1f} ms")
    print(f"wall: {wall_s:.2f} s  audio: {audio_s:.1f} s  real-time factor: {rtf:.1f}x")
    print(f"throughput: {total_chunks / wall_s:.1f} chunks/s (decode included)")

    if csv_path and per_file_rows:
        import csv as _csv

        with open(csv_path, "w", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=list(per_file_rows[0].keys()))
            w.writeheader()
            w.writerows(per_file_rows)
        print(f"results CSV -> {csv_path}")

    return {"files": len(per_file_rows), "chunks": total_chunks,
            "wall_s": wall_s, "rtf": rtf,
            "chunks_per_sec": total_chunks / wall_s if wall_s else 0.0,
            "per_file": per_file_rows, "timed_out": timed_out}


def run_benchmark_pipelined(runner, cfg, classes, files, top_k=3,
                            batch_size=64, overlap=0.0, csv_path=None,
                            score_threshold=0.0, decode_workers=4,
                            max_outstanding=16, device_resample=False,
                            cache_dir=None, int16_io=False,
                            ulaw_io=False, device="cuda") -> dict:
    """Pipelined serving driver: threaded decode overlapped with the
    device's queued work.

    The serial driver alternates host decode and device compute, leaving
    each idle half the time. Here `decode_workers` threads decode ahead
    while the main thread queues classify batches without waiting for them
    (`make_classifier_cache(as_numpy=False)`: the scores stay on the
    device and no batch synchronizes); at most `max_outstanding` batches
    stay in flight before the oldest is drained by one copy to the host.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from birdnet_stm32_tpu_torch.models.serving import (
        decode_for_classify,
        make_classifier_cache,
        top_predictions,
    )

    classifier_for = make_classifier_cache(
        runner, cfg, as_numpy=False,
        input_dtype="int16" if int16_io else ("ulaw" if ulaw_io else None),
        device=device)

    def decode(path):
        # int16 conversion happens inside decode_for_classify, on this
        # decode thread (raw PCM16 codes when eligible, requantize else).
        return decode_for_classify(
            path, cfg, overlap, max_duration=None,
            device_resample=device_resample, cache_dir=cache_dir,
            int16_io=int16_io, ulaw_io=ulaw_io)

    print(f"[info] pipelined serving: {decode_workers} decode threads, "
          f"<= {max_outstanding} device batches in flight")
    _warmup_all_rates(lambda r: (lambda w: _to_host(classifier_for(r)(w))),
                      cfg, batch_size, files, device_resample,
                      np.int16 if int16_io else (np.int8 if ulaw_io
                                                 else np.float32))

    per_file_rows = []
    total_chunks = 0
    audio_s = 0.0
    # Cross-file chunk packing: chunks from consecutive files share device
    # batches (separately per source rate — shapes differ), so no batch is
    # padded except the last one per rate. Without packing, a 20-chunk file
    # wastes 2/3 of every B=64 batch on zero padding.
    bufs: dict[int, list] = {}      # rate -> pending chunk arrays
    buf_n: dict[int, int] = {}      # rate -> pending chunk count
    drained: dict[int, list] = {}   # rate -> drained np [B, C] arrays
    recs: list = []                 # (rec, rate, start, count) in file order
    pos: dict[int, int] = {}        # rate -> packed-chunk cursor
    outstanding: deque = deque()    # (rate, dev_scores) FIFO

    def drain_oldest():
        r, dev = outstanding.popleft()
        drained.setdefault(r, []).append(_to_host(dev))

    def flush_rate(rate, pad=False):
        """Enqueue full batches from bufs[rate]; pad the tail when pad."""
        buf = bufs[rate]
        while buf_n[rate] >= batch_size or (pad and buf_n[rate] > 0):
            take, got = [], 0
            while got < batch_size and buf:
                piece = buf[0]
                need = batch_size - got
                if len(piece) <= need:
                    take.append(buf.pop(0))
                else:
                    take.append(piece[:need])
                    buf[0] = piece[need:]
                got += len(take[-1])
            wave = np.concatenate(take) if len(take) > 1 else take[0]
            buf_n[rate] -= len(wave)
            if len(wave) < batch_size:
                wave = np.pad(wave, ((0, batch_size - len(wave)), (0, 0)))
            outstanding.append((rate, classifier_for(rate)(wave)))  # no block
            while len(outstanding) > max_outstanding:
                drain_oldest()

    t_all0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=decode_workers) as ex:
        # Bounded decode-ahead window: submitting every file up front would
        # buffer the whole dataset's waveforms in RAM when the device is
        # the slower stage.
        window = max(2 * decode_workers, 4)
        futures = deque((p, ex.submit(decode, p)) for p in files[:window])
        next_file = window
        while futures:
            path, fut = futures.popleft()
            if next_file < len(files):
                futures.append((files[next_file], ex.submit(decode, files[next_file])))
                next_file += 1
            chunks, src_rate, dur_s, read_ms = fut.result()
            if chunks.shape[0] == 0:
                print(f"file: {Path(path).name}  SKIP (no audio)")
                continue
            audio_s += dur_s
            bufs.setdefault(src_rate, [])
            buf_n.setdefault(src_rate, 0)
            pos.setdefault(src_rate, 0)
            recs.append(({"file": str(path), "chunks": len(chunks),
                          "read_ms": read_ms, "frontend_ms": 0.0,
                          "model_ms": 0.0},
                         src_rate, pos[src_rate], len(chunks)))
            pos[src_rate] += len(chunks)
            bufs[src_rate].append(chunks)
            buf_n[src_rate] += len(chunks)
            total_chunks += len(chunks)
            flush_rate(src_rate)
        for rate in list(bufs):
            flush_rate(rate, pad=True)
        while outstanding:
            drain_oldest()

    wall_s = time.perf_counter() - t_all0

    flat = {r: np.concatenate(v) for r, v in drained.items()}
    for rec, rate, start, count in recs:
        scores = flat[rate][start : start + count]
        pooled = scores.mean(axis=0)
        top = top_predictions(pooled, top_k, score_threshold)
        preds = ", ".join(f"{classes[i]} ({pooled[i]:.3f})" for i in top)
        print(f"file: {Path(rec['file']).name}  chunks: {rec['chunks']}  top: {preds}")
        print(f"[BENCH] read: {rec['read_ms']:.1f} ms  frontend: 0.0 ms  "
              f"model: 0.0 ms  total: {rec['read_ms']:.1f} ms")
        rec.update(top1=classes[int(top[0])], score=float(pooled[top[0]]))
        per_file_rows.append(rec)
    rtf = audio_s / wall_s if wall_s > 0 else float("inf")
    print("=== DONE ===")
    print(f"files: {len(per_file_rows)}  chunks: {total_chunks}")
    print("avg per file: read 0.0 ms, frontend 0.0 ms, model 0.0 ms "
          "(stages overlap in pipelined mode)")
    print(f"wall: {wall_s:.2f} s  audio: {audio_s:.1f} s  real-time factor: {rtf:.1f}x")
    print(f"throughput: {total_chunks / wall_s:.1f} chunks/s (decode included, pipelined)")

    if csv_path and per_file_rows:
        import csv as _csv

        with open(csv_path, "w", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=list(per_file_rows[0].keys()))
            w.writeheader()
            w.writerows(per_file_rows)
        print(f"results CSV -> {csv_path}")

    return {"files": len(per_file_rows), "chunks": total_chunks,
            "wall_s": wall_s, "rtf": rtf,
            "chunks_per_sec": total_chunks / wall_s if wall_s else 0.0,
            "per_file": per_file_rows, "timed_out": False}


def main(argv=None) -> int:
    args = get_args(argv)
    if args.int16_io and args.ulaw_io:
        raise SystemExit("--int16_io and --ulaw_io are mutually exclusive")

    import torch

    from birdnet_stm32_tpu_torch.cli.deploy import resolve_config_path
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.data.dataset import supported_audio_extensions
    from birdnet_stm32_tpu_torch.data.species import open_species_list
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner

    dtype = torch.bfloat16 if args.bf16 else None
    device = resolve_device(args.device)
    args.config_path = resolve_config_path(args.model_path, args.config_path)
    runner = load_model_runner(Path(args.model_path), dtype=dtype, device=device)
    cfg = getattr(runner, "cfg", None)
    if cfg is None:
        if args.config_path is None:
            raise SystemExit("--config_path required for .tflite models "
                             "(no model_config.json sidecar found next to "
                             f"{args.model_path})")
        cfg = ModelConfig.load(args.config_path)
    classes = (open_species_list(args.labels_path) if args.labels_path
               else cfg.class_names)
    classes = _resolve_classes(classes, cfg)

    files = sorted(str(p) for p in Path(args.audio_dir).rglob("*")
                   if p.suffix.lower() in supported_audio_extensions())
    if not files:
        raise SystemExit(f"no audio files under {args.audio_dir}")
    if args.pipeline > 0:
        def drive():
            run_benchmark_pipelined(
                runner, cfg, classes, files, top_k=args.top_k,
                batch_size=args.batch_size, overlap=args.chunk_overlap,
                csv_path=args.csv, decode_workers=args.pipeline,
                device_resample=args.device_resample,
                cache_dir=args.cache_dir, int16_io=args.int16_io,
                ulaw_io=args.ulaw_io, device=device)
    else:
        def drive():
            run_benchmark(runner, cfg, classes, files, top_k=args.top_k,
                          batch_size=args.batch_size, overlap=args.chunk_overlap,
                          csv_path=args.csv, device_resample=args.device_resample,
                          cache_dir=args.cache_dir, int16_io=args.int16_io,
                          ulaw_io=args.ulaw_io, device=device)

    if args.trace_dir:
        path = trace(drive, args.trace_dir, cuda=device.type == "cuda")
        print(f"profiler trace -> {path}")
    else:
        drive()
    return 0


def _to_host(scores) -> np.ndarray:
    """Scores to the host: one copy of a device tensor, which waits for its
    batch only (the interpreter leg already returns numpy)."""
    return scores.cpu().numpy() if hasattr(scores, "cpu") else np.asarray(scores)


def trace(fn, trace_dir, cuda: bool) -> Path:
    """Run fn under torch.profiler (CPU, and CUDA when `cuda`) and write
    the Chrome trace to <trace_dir>/benchmark_trace.json; returns its path."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    path = Path(trace_dir) / "benchmark_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def _resolve_classes(classes, cfg) -> list[str]:
    """Validate class names before the warm-up: an empty list (a sidecar
    without class_names, no --labels_path) gets placeholder names; fewer
    names than the model's classes fails fast instead of an IndexError on
    the first file."""
    if not classes:
        print(f"[warn] no class names (config class_names empty, no "
              f"--labels_path); using class_0..class_{cfg.num_classes - 1}")
        return [f"class_{i}" for i in range(cfg.num_classes)]
    if len(classes) < cfg.num_classes:
        raise SystemExit(f"labels list has {len(classes)} names but the "
                         f"model outputs {cfg.num_classes} classes")
    return list(classes)


if __name__ == "__main__":
    raise SystemExit(main())
