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
   against their plain versions, within the same tolerances. Then the
   linear kernel at EfficientNet-B1's input (gpubench/configs/
   effnet-b1-bf16.json: B=64, T=160000, n_fft 512, hop 320, 500 frames),
   called as the hybrid frontend calls it, against its plain version
   (max abs <= 1e-5), launched once from a cleared counter, and timed;
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
   (e) on each leg one warm served model call (runner.forward_block at
       B=64, a CUDA graph replay: the wrappers' launch counter must stay
       at zero) launches int8_conv_taps_kernel 12 times and
       int8_conv_pointwise_kernel 11 times, counted by name on the card
       (torch.profiler), with their device time;
5b. int8 conv phase: the flagship executor at B=64 launches each int8
   convolution kernel once per served op (12 taps, 11 pointwise, 7 of
   them with the residual ADD); each served op's kernel step is bit-equal
   to its plain step on the card and is timed beside its byte bound, the
   plain step and a cuDNN float32 convolution of the same shape; the two
   kernels join the `kernels` line with (e)'s launches and device time;
6. bf16 phase: the flagship in bf16 at full width (seeded init_model)
   through make_fused_classifier(TorchRunner(model, cfg,
   dtype=torch.bfloat16), cfg) on the hybrid requests (3 x 64 + 37):
   every floating parameter and buffer bf16; scores [229, 100] finite;
   the linear kernel launched once per batch and nothing else; mean score
   cosine >= 0.999 against the fp32 leg on the same waveforms (bench.py's
   bf16 gate; the minimum printed) and >= 0.999 against the port's CPU
   bf16 path on 8 rows; then one 64-chunk batch of each leg by part (copy,
   kernel, cast, DS-CNN forward, whole call; CUDA events, the legs in
   turns, median of three rounds);
7. fuzz phase: the nine configurations the JAX package's executor fuzz
   test serves (tests/goldens/torch_fuzz, read by
   tests/torch_fuzz_fixtures.py): the CUDA executor on the committed
   features equal to the JAX goldens bit for bit, requant exact and fast
   (a SOFTMAX graph may instead be within one output quantum, 1.5/256,
   with >= 95 % exact, and is then named); the float32 leg (TF32 off)
   within 1e-5 of the JAX scores, the bf16 leg at cosine >= 0.999 of the
   JAX bf16 scores, the float32 logits (class_activation "none") card vs
   CPU within FUZZ_LOGIT_RTOL of each row's spread (the reading is
   printed); each config's waveforms through make_fused_classifier
   on CUDA on the fp32, bf16 and INT8 legs: the kernel-fed features within
   the kernel phase's tolerance of the JAX features, the config's kernel
   launched (linear for hybrid, the features kernel for librosa, log_mel
   and mfcc, none for raw), INT8 scores at cosine >= 0.999 of the CPU
   path and bf16 at >= 0.999 of fp32; then the executor's steps, CUDA
   launches and device time per 64-chunk batch on the flagship graph with
   and without the layout pre-passes (the same scores);
8. serve phase: the port's `serve` entry point
   (birdnet_stm32_tpu_torch/cli/serve.py) and its waveform ingress:
   (a) writes seeded WAVs (PCM16 mono at 22.05 kHz, 10 s and 31 s; PCM16
       stereo at 44.1 kHz; PCM16 mono at 48 and 16 kHz; float32 mono at
       22.05 kHz) and runs `__main__.main(["serve", ..., "--once"])` in
       this process on CUDA (the default device) with the committed bundle,
       with float ingress, --int16_io, --ulaw_io and --device_resample,
       the launch counts cleared before each run: one TSV row per file,
       100 finite scores each, the linear float kernel launched once per
       batch and nothing else; --int16_io rows equal to the float rows for
       the mono PCM16 files at 22.05 kHz (raw codes), --ulaw_io within the
       JAX gate (cosine > 0.995, |diff| <= 0.1), --device_resample per-file
       cosine >= 0.999 against host resampling; a second run of each mode
       serves no file (resume);
   (b) through make_fused_classifier: on the float leg (hybrid, full
       width, seeded weights) int16 ingress of raw-code batches bit-equal
       to float ingress, and input_sample_rate 48000 and 16000 within atol
       1e-5 / rtol 1e-4 of the host-resampled batch; int16 ingress through
       the fixture's fused int8-entry leg bit-equal to its float ingress;
   (c) on the card: _dequantize_int16 over every int16 code against every
       scale code (1..32767, -32768, 0), 2^31 quotients, each equal to the
       float64 quotient rounded to float32; the mu-law decoder on all 256
       codes within 2e-7 of the CPU; the resampler 48 / 44.1 / 16 kHz ->
       22.05 kHz at B=64 within 2e-5 of the CPU;
   (d) one warm 64-chunk batch per ingress mode (float32, int16, mu-law,
       float32 at 48 kHz resampled on the card) on both legs, by part
       (CUDA events): host-to-device copy, ingress, frontend, model, whole;
       the modes in turns, three rounds, the median of each part;
9. tile phase: the tile grid (grid="tile", the port of _kernel_tile) of
   every specialisation of the kernel phase at each batch_tile of 2, 4, 8
   and 16, on the kernel phase's input: bit-equal to the sample-grid
   kernel, within the kernel phase's tolerance of the plain version, the
   same again after its timing launches; times by CUDA
   events; and grid="tile" at B=6 with batch_tile 4 raises ValueError;
10. bench phase: the port's frontend benchmark entry
   (birdnet_stm32_tpu_torch/scripts/bench_frontend.py) at B=256 on CUDA,
   with the launch counts cleared just before: its numerics within 1e-5 of
   the composition; on the B=256 input it times, the sample grid within
   1e-5 of the composition and every tile's features finite, bit-equal to
   the sample grid and within 1e-5; the INT8 scores finite, their entry
   codes at most one apart on under 1 %, min cosine >= BENCH_MIN_COSINE;
   and the tile-grid kernel launched; it prints the bench's three
   sections;
11. train phase (after the serve phase): the port's `train` entry point
   (birdnet_stm32_tpu_torch/cli/train.py):
   (a) writes a seeded WAV folder: a folder per flagship class (100) and a
       noise folder, 3 mono PCM16 files at 22.05 kHz of 4-7 s each, a
       chirp-and-tone pattern per class with noise (~70 MB);
   (b) runs `__main__.main(["train", ...])` in this process on CUDA (the
       default device) at the flagship's full width (hybrid, pwl, n_fft
       512, 64 mels, 256 frames, alpha 1.0, embeddings 256, plain DS, no
       SE) with the defaults otherwise (int16 feed, mixup, SpecAugment, 4
       loader workers): batch 64, 2 epochs x 8 steps, then `--resume` for a
       third epoch, the launch counts cleared before each run: parameters
       and batches on CUDA, the int16 rows reaching the batcher; the linear
       kernel launched exactly once per train step and per validation
       batch and nothing else; every loss finite and the last epoch's below
       the first's; history.csv with 3 rows; best/, last/ and the sidecars;
       the resumed optimizer at step 24;
   (c) serves the trained run directory with `serve` on two of its files
       (sigmoid head: 100 finite scores in [0, 1] per file); then
       train_model on the librosa + pwl config at full width (two steps on
       one int16 batch with SpecAugment and mixup, one validation batch):
       the features kernel (mel + pwl) launched exactly three times;
   (d) one train step from the same state on 16 rows of the first int16
       batch of a FIFO loader, the card against the port's CPU path
       (dropout 0, no augmentation, SGD, L2 on): the kernel's features
       within 1e-5 of the plain version's; then both steps on the card's
       features: loss within 1e-6 and grad norm within 1e-3 relative, each
       tensor's update within 5e-2 and the whole update within 2e-2 in L2
       norm, every BN statistic within 1e-5 of its tensor's largest value;
   (e) prints the batcher's and the adam train step's median ms over 7
       CUDA-event timings at batch 64, their CUDA launches and device-busy
       ms (torch.profiler), the chunks/s they allow, and each epoch's
       data_wait_s / dispatch_s / val_s, the host loop's chunks/s (steps x
       batch over data_wait_s + dispatch_s) and the epoch's chunks/s
       (steps x batch over the epoch's seconds, which end after the
       validation sweep has read its scores back), with the card's name
       and power limit;
12. evaluate phase (after the train phase, on its folder and run
   directory): the port's `evaluate`, `benchmark`, `board-test` and
   `profile` verbs in this process on CUDA (the default device):
   (a) `evaluate` on the evaluate subset (the first file of each of the
       100 classes, 2-3 chunks each) with `--max_files 1 --batch_size 64
       --optimize_thresholds --bootstrap_ci --n_bootstrap 50 --det_curve
       --benchmark_latency --profile_memory --save_csv
       --save_benchmark_json`: the committed bundle plain, with
       --int16_io and twice with --cache_dir (a miss, then hits), and the
       train phase's run in float32 and with --bf16; then the INT8,
       float32 and bf16 commands with --device cpu. Checks: 100 files and
       finite [100, 100] pooled scores; finite metrics (every class has a
       file); the report files; the linear kernel launched once per device
       batch (ceil(chunks / 64), plus the --benchmark_latency warm-up
       batch) and no other kernel; --int16_io and both cached passes
       bit-equal to the plain INT8 run; the card against the CPU per file:
       float32 within 1e-4, bf16 and INT8 at cosine >= 0.999, roc-auc,
       cmAP and mAP within EVAL_METRIC_ATOL;
   (b) `benchmark` of the bundle over the serve phase's six files, serial,
       --pipeline 4, --int16_io, --ulaw_io, --device_resample and
       --trace_dir: a [BENCH] line per file and `=== DONE ===`; the linear
       kernel launched once per device batch (plus one warm-up batch per
       source rate) and nothing else; the pipelined per-file top-1 and
       score within 1e-5 of the serial ones; the trace names the linear
       kernel;
   (c) `board-test` from a TOML deploy config naming the bundle and the six
       files: the --save_results CSV (file, top_label, top_score), a row
       per file;
   (d) `profile` of the flagship config: its parameter count equals the
       port's DS-CNN's;
   (e) prints each evaluate leg's chunks/s and each benchmark mode's
       `=== DONE ===` wall, real-time factor and chunks/s, with the card's
       name and power limit;
13. train-options phase (after the evaluate phase, on the train phase's
   folder and run directory): the `train` options in this process on CUDA
   at the flagship's full width, batch 64, reading the WAVs in-process
   (`--num_workers 0`; the LR finder with the default pool); every run
   counts its train steps and validation batches, and the linear kernel
   must launch once per each and nothing else:
   (a) `train --mixed_precision`, 1 epoch x 8 steps: the masters float32
       on CUDA, the batcher's features bf16, the stem convolution's input
       and weight bf16 in training and float32 in validation (a dtype
       spy), the step losses finite and falling (second half below the
       first); one bf16 step's loss within MIXED_LOSS_RTOL of the float32
       step's from the trained run's state on the first int16 batch;
   (b) `train --qat`, then `--qat --qat_act`, each 2 epochs x 4 steps on
       the trained run: `<run>_qat` written, every BN tensor equal to the
       base run's and every kernel moved, finite losses; `serve` of
       `<run>_qat`; quantize_params (per channel and per tensor) of the
       run's weights and fake_quantize_act on the card bit-equal to the
       CPU; one QAT step from the run's weights card vs CPU on the card's
       features at the train phase's step gates; train_model with QAT and
       activation fake-quant on librosa + pwl, 2 steps and a validation
       batch (the features kernel, 3 launches);
   (c) `train --linear_probe`, 1 epoch x 4 steps: every backbone tensor
       of `<run>_probe` bit-identical to the run's, the head moved;
   (d) `train --find_lr` (the 100-step sweep, float32 feed): one batch and
       one launch per learning rate of the sweep, a finite suggestion
       inside it;
   (e) `train --tune 2`, each trial 2 epochs x 4 steps: trial_0, trial_1
       and best_params.json;
   (f) run_distillation (the API; there is no CLI option) of a fresh
       student against the trained run (sigmoid head), 1 epoch x 4 steps
       on the float32 feed: finite losses, the student's run directory;
   (g) prints the float32, mixed-precision and QAT (activation fake-quant
       off and on) adam steps' median ms over 7 CUDA-event timings at
       batch 64 from the trained run's state, each with its CUDA launches
       and device-busy ms (torch.profiler), and the card's name and power
       limit;
14. convert phase (after the train-options phase, on the train phase's
   WAV folder; tests/make_torch_convert_fixtures.py made the export where
   TensorFlow is, from the flagship geometry with seeded weights):
   (a) `convert` of a run directory of the committed weights: without
       TensorFlow (the card machines this runs on have none) it exits 2 naming TensorFlow,
       before it loads or calibrates anything (both are replaced by
       raisers for the call); where TensorFlow imports, the real
       conversion runs instead and a line says so;
   (b) the verb's calibration features (stratified sampling,
       representative_inputs: the composition) on CUDA and on the CPU: the
       same kept count, features within CONVERT_FEATURE_TOL;
   (c) the committed weights (TorchRunner) and the committed export
       (TFLiteSimRunner) on CUDA and on the CPU over the card's validation
       subset (the verb's seed): the executor bit-equal card vs CPU, the
       float scores within CONVERT_FLOAT_RTOL of each row's spread,
       validate_runners' stats within CONVERT_STATS_TOL card vs CPU and
       within CONVERT_REPORT_TOL of the committed report's cosine_mean;
   (d) get_spectrogram_from_audio (the composition) on one seeded
       flagship chunk, linear and mel + pwl, on CUDA within
       SPECTROGRAM_API_TOL of the CPU;
   (e) prints one `convert_phase` line: calibration ms per device,
       validation ms per leg, n_samples, the gaps;
15. deploy phase: `deploy` in-process on CUDA of the committed flagship
   bundle's .tflite (config and labels derived) into a temporary
   directory: its manifest equal to the committed manifest.json (every
   sha256 and size, the firmware headers the JAX package generated
   included); validate_bundle launches the linear kernel once; the
   deployed and the source .tflite classify one seeded batch bit-equal;
   then `deploy` of the convert fixture's export: its headers, config and
   labels hash as the flagship's, its .tflite as the committed file. Every
   launch of the phase is counted from zero (4 linear launches). Prints
   one `deploy_phase` line: files, validate ms, launches;
16. transplant phase: the committed flagship-geometry reference archive
   (tests/goldens/torch_transplant/, seeded weights, softmax head) served
   on CUDA through make_fused_classifier + classify_in_batches on the
   hybrid requests (3 x 64 + 37): where h5py imports, through
   load_model_runner on the .keras (its sidecar derived) and then the
   `serve` verb on the serve phase's six files (six rows of 100 finite
   scores); without h5py (the card machines this runs on have none), a
   line says so and the committed transplanted weights are served with the
   architecture and head read from the archive's config.json. Checks:
   scores [229, 100] finite, the linear kernel launched once per batch and
   nothing else, one batch within TRANSPLANT_CPU_ATOL of the same port on
   the CPU;
17. export phase: export_serving_fn of the archive's model on CUDA at
   batch EXPORT_B, loaded back (load_serving_fn): within EXPORT_EAGER_ATOL
   of the eager composition classifier and EXPORT_KERNEL_ATOL of the
   kernel-fed make_fused_classifier (one linear launch); the INT8 export
   of the flagship .tflite bit-equal to the eager executor fed by the
   composition; `deploy --stablehlo` of the flagship bundle: the manifest
   lists serving_module.pt2 and the module (batch 64) is bit-equal to the
   executor. Prints export seconds, load ms and the programs' and the
   eager paths' median ms (CUDA events), with the card's name and power
   limit;
18. codec phase: the native audio library (audio/native.py, built with
   g++): the native WAV read of the serve phase's six files bit-equal to
   the numpy reader, the native resampler within 5e-6 of scipy; where
   libav is found, flac / ogg / mp3 tones encoded with codec_encode join
   them, else a line says it is absent; `benchmark` of the bundle over
   the folder on CUDA: a [BENCH] line per file and the linear kernel
   launched once per device batch plus the warm-up batch. Prints the
   decode ms per file (native and numpy RIFF, or codec);
19. ddp phase (tests/torch_ddp_worker.py): one sgd step at lr GATE_LR of
   the archive's model on DDP_ROWS rows of kernel features: (a) under a
   NCCL process group of one rank, bit-equal to the step without a group
   (each in a process of its own with torch's deterministic algorithms);
   (b) two processes over gloo on the one card, each on half the rows,
   against (a)'s process without a group on all of them, at the gates of
   scripts/multichip.py::step_gates (printed); (c) `train` in two ranks (gloo)
   at the flagship's full width, 1 epoch x DDP_STEPS steps, each rank
   counting its steps, validation batches and launches: DDP_STEPS steps
   each, the linear kernel launched once per step and validation batch,
   the same global losses on both ranks, best/ written by rank 0. Prints
   the gates' readings, the wall seconds, each rank's median step ms (host
   clock around the step and the read of its loss) and the card's name
   and power limit;
20. mesh phase: serving over a local mesh (the runners' mesh=,
   parallel/mesh.py) on the committed flagship bundle (the graph, entry
   unfused, and its entry-transpose fixture, the fused int8 entry) and
   the convert fixture's committed flagship weights (float32, softmax
   head; bf16 with a logits head), MESH_ROWS rows per batch, against the
   same classifiers without a mesh on cuda:0: a mesh of cuda:0 alone
   bit-equal on every leg and the embedder; two entries on cuda:0 (and,
   with more than one card, a mesh of every card): both INT8 legs bit-equal
   under float32, int16, mu-law and 48 kHz resampled ingress, float32
   scores and embeddings within MESH_F32_ATOL, bf16 logits at per-row
   cosine >= MESH_BF16_MIN_COSINE; every call launches its kernel once per
   shard and nothing else (counted from zero around each call), returns
   its scores on cuda:0, and each shard's kernel output equals its plain
   version on its card. Prints the gaps, ms per batch and chunks/s per
   width at B=64 and 256 for the INT8, float32 and bf16 legs (host clock,
   median of MESH_REPS calls that copy the scores back) with one call's
   CUDA launches and summed device time over the cards (torch.profiler),
   the row blocks' copies alone, and the card's name and power limit;
21. prints the `kernels` JSON line (the linear and mel + pwl entries with
   `train_launches` and `train_options_launches`, the linear entry with
   `evaluate_launches`, `convert_launches`, `deploy_launches`,
   `transplant_launches`, `export_launches`, `codec_launches` and
   `ddp_launches`, both linear entries with `mesh_launches`), the card's
   name and power limit, and last the `ok` JSON line.

Any failed check exits non-zero before the `ok` line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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
# EfficientNet-B1's input (gpubench/configs/effnet-b1-bf16.json): 5 s at
# 32 kHz, 500 frames, so hop 320.
PERCH_T, PERCH_SR, PERCH_WIDTH, PERCH_MELS = 160000, 32000, 500, 160
# The bench's INT8 score agreement between its two feeds on 32 chunks: an
# H100 80GB HBM3 read a min cosine of 0.999085 here; a feature near a code
# boundary flips one entry code, and the bit-exact executor carries it on.
BENCH_MIN_COSINE = 0.998
KERNEL_SOURCE = "birdnet_stm32_tpu_torch/ops/csrc/frontend_kernel.cu"
INT8_CONV_SOURCE = "birdnet_stm32_tpu_torch/ops/csrc/int8_conv_kernel.cu"
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


def cuda_ms_median(torch, fn, n: int = 7, warmup: int = 2) -> float:
    """Median of n CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


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


def perch_geometry_phase(torch) -> None:
    """The linear kernel at EfficientNet-B1's input geometry (PERCH_*),
    called as frontend_input calls it for the hybrid frontend, against its
    plain version (max abs 1e-5), one launch from a cleared counter."""
    from birdnet_stm32_tpu_torch.device import full_fp32
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel as fk

    g = torch.Generator(device="cuda").manual_seed(1)
    y = 0.5 * torch.randn(B, PERCH_T, generator=g, device="cuda")
    hop = PERCH_T // PERCH_WIDTH
    name = fk.kernel_name("linear", "none")

    def kernel():
        return fk.fused_spectrogram(y, mode="linear", mag_scale="none", sample_rate=PERCH_SR,
                                    n_fft=N_FFT, mel_bins=PERCH_MELS, spec_width=PERCH_WIDTH)

    with full_fp32():
        fk.launches.clear()
        got = kernel()
        torch.cuda.synchronize()
        launched = dict(fk.launches)
        ref = fk.fused_spectrogram_plain(y, N_FFT, hop, PERCH_WIDTH, mode="linear",
                                         mag_scale="none", sample_rate=PERCH_SR,
                                         mel_bins=PERCH_MELS)
        torch.cuda.synchronize()
        shape = (B, N_FFT // 2 + 1, PERCH_WIDTH)
        if got.shape != shape or ref.shape != shape or not torch.isfinite(got).all():
            fail(f"{name} at T={PERCH_T}: {tuple(got.shape)} / plain {tuple(ref.shape)}, "
                 f"not finite or not {shape}")
        err = (got - ref).abs().max().item()
        report = {"perch_geometry": {"kernel": name, "B": B, "T": PERCH_T, "n_fft": N_FFT,
                                     "hop": hop, "frames": PERCH_WIDTH, "launches": launched,
                                     "max_abs_vs_plain": err}}
        if launched != {name: 1}:
            fail(f"{name} at T={PERCH_T}: launches {launched}, not one of {name}")
        if not err <= 1e-5:
            fail(f"{name} at T={PERCH_T}: max abs {err} > 1e-5 against its plain version")
        report["perch_geometry"]["ms"] = cuda_ms(torch, kernel)
        report["perch_geometry"]["plain_ms"] = cuda_ms(torch, lambda: fk.fused_spectrogram_plain(
            y, N_FFT, hop, PERCH_WIDTH, mode="linear", mag_scale="none"), iters=5, warmup=1)
    print(json.dumps(report))


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


def device_activity(torch, fn, prefix: str | None = None) -> dict:
    """The CUDA kernels, copies and memsets one call of fn() puts on the
    card, and the sum of their device times (ms), by torch.profiler; both
    None when the profiler sees no device event. With `prefix`, also
    `by_name`: {kernel name: [launches, ms]} of the kernels whose name
    (less its return type and template arguments) starts with it."""
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
    out = {"cuda_launches": len(events) or None, "device_busy_ms": busy if events else None}
    if prefix is not None:
        by_name = {}
        for e in events:
            name = re.split(r"[<(]", e.name.removeprefix("void "), maxsplit=1)[0]
            if name.startswith(prefix):
                n, ms = by_name.get(name, (0, 0.0))
                by_name[name] = [n + 1, ms + e.time_range.elapsed_us() / 1e3]
        out["by_name"] = by_name
    return out


def int8_phase(torch, np, flagship_cfg) -> tuple[dict[str, int], dict[str, list]]:
    """The INT8 leg, (a)-(e) of the module docstring; returns the int8
    frontend kernel's launches on the fused leg, and {int8 conv kernel:
    [launches, device ms]} of one served batch of the flagship leg."""
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        make_fused_classifier,
    )
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.ops.kernels import int8_conv_kernel as K
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
        with torch.no_grad():
            feats = frontend_kernel.frontend_input(x, cfg, quant=quant)
            print(json.dumps({"int8_leg": leg, "batch_breakdown_ms": {
                "h2d_copy": cuda_ms(torch, lambda: wave.cuda()),
                "frontend_kernel": cuda_ms(torch, lambda: frontend_kernel.frontend_input(
                    x, cfg, quant=quant)),
                "executor": cuda_ms(torch, lambda: runner.forward_block(feats)),
                "classify_total": cuda_ms(torch, lambda: classify(requests[0])),
            }, "executor_per_batch": device_activity(
                torch, lambda: runner.forward_block(feats))}))

    # (e) the served model call, warm (a CUDA graph replay, which leaves
    # the wrappers' launch counter still), launches the int8 conv kernels
    # once per body convolution, counted by name on the card.
    served = {}
    for leg, (classify, runner, _, _) in legs.items():
        with torch.no_grad():
            feats = frontend_kernel.frontend_input(x, cfg, quant=classify.entry_quant)
            runner.forward_block(feats)
            K.launches.clear()
            activity = device_activity(torch, lambda: runner.forward_block(feats),
                                       prefix="int8_conv")
        by_name = activity["by_name"]
        print(json.dumps({"int8_leg": leg, "served_int8_conv_b64": by_name,
                          "eager_launches_during_replay": dict(K.launches)}))
        counts = {k: n for k, (n, _) in by_name.items()}
        if counts != {K.TAPS_KERNEL: 12, K.POINTWISE_KERNEL: 11}:
            fail(f"INT8 {leg}: the served model call launched {counts}, want "
                 f"{K.TAPS_KERNEL} x 12 and {K.POINTWISE_KERNEL} x 11")
        if K.launches:
            fail(f"INT8 {leg}: the served model call ran eagerly ({dict(K.launches)}), "
                 "not as its CUDA graph")
        served[leg] = by_name
    name = frontend_kernel.kernel_name("linear", "none", quant=True)
    return {name: legs["fixture"][3]}, served["flagship"]


# The serve phase's files: (name, rate, seconds, channels, sample format).
SERVE_FILES = (("pcm16_22k_10s.wav", 22050, 10.0, 1, "pcm16"),
               ("pcm16_22k_31s.wav", 22050, 31.0, 1, "pcm16"),
               ("pcm16_44k_stereo.wav", 44100, 6.0, 2, "pcm16"),
               ("pcm16_48k.wav", 48000, 6.0, 1, "pcm16"),
               ("pcm16_16k.wav", 16000, 6.0, 1, "pcm16"),
               ("float32_22k.wav", 22050, 6.0, 1, "float32"))
SERVE_MODES = {"float": [], "int16": ["--int16_io"], "ulaw": ["--ulaw_io"],
               "device_resample": ["--device_resample"]}
# The JAX gate of the mu-law ingress (tests/test_ulaw_feed.py): score
# cosine > 0.995 and |diff| <= 0.1 against float ingress.
ULAW_MIN_COSINE, ULAW_MAX_ABS = 0.995, 0.1
# The gate the port applies to INT8 feeds that may move an entry code.
FEED_MIN_COSINE = 0.999
RESAMPLE_RATES = (48000, 44100, 16000)


def int8_conv_phase(torch, np, served: dict[str, list]) -> list[dict]:
    """(5b): each int8 convolution kernel at the flagship's shapes (B=64)
    against the executor's plain step on the card: bit-equal, and its
    device time per call (torch.profiler: the call's kernels summed, so
    the host's issue time, which exceeds a kernel's here, is left out)
    beside its byte bound (each input code read once, the residual and the
    weights once, each output code written once, at HBM_BYTES_PER_S), the
    plain step's device time and that of one cuDNN float32 convolution of
    the same shape (`library_ms`, the accumulation alone; the port never
    calls it). Returns one `kernels` entry per kernel: its launches and
    device ms in the served batch of the INT8 phase (`served`, {kernel:
    [launches, ms]}), its ops' bounds, plain and library times summed."""
    import torch.nn.functional as F

    from birdnet_stm32_tpu_torch.ops.kernels import int8_conv_kernel as K
    from birdnet_stm32_tpu_torch.quant import tflite_import as P
    from tests.int8_fixture import flagship_features

    graph = P.TFLiteGraph(FLAGSHIP_TFLITE)
    plan = P.layout_plan(graph)
    kplan = P.kernel_plan(graph, plan)
    x = torch.from_numpy(flagship_features(B)).cuda()
    K.launches.clear()
    vals = P.build_executor(graph, B, device="cuda", return_all=True)(x)
    launches = dict(K.launches)
    if launches != {K.TAPS_KERNEL: 12, K.POINTWISE_KERNEL: 11}:
        fail(f"int8 conv: the flagship executor launched {launches}, want 12 taps + 11 pointwise")
    dev = torch.device("cuda")
    kernels = {graph.ops[k].outputs[0]: name for k, name in kplan.kernel.items()}
    fused = {conv: add for add, conv in kplan.fused_add.items()}
    rows, totals = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    sums = {name: dict.fromkeys(totals, 0.0) for name in served}
    calls = 10

    def per_call_ms(fn):
        """Device ms per call of fn(), over `calls` calls after a warm one."""
        fn()
        busy = device_activity(torch, lambda: [fn() for _ in range(calls)])["device_busy_ms"]
        return None if busy is None else busy / calls

    for k in sorted(kplan.kernel):
        op = graph.ops[k]
        add = graph.ops[fused[k]] if k in fused else None
        out = op.outputs[0] if add is None else add.outputs[0]
        inputs = {t: vals[t] for t in (op.inputs[0], *(add.inputs[:2] if add else ()))}
        on_card = P._op_conv(P._Build(graph, dev, "exact", plan, kernels), op, add=add)
        plain_steps = [P._op_conv(P._Build(graph, dev, "exact", plan), op)]
        if add is not None:
            plain_steps.append(P._op_add_sub(P._Build(graph, dev, "exact", plan), add))

        def kernel_call(step=on_card, inputs=inputs):
            v = dict(inputs)
            step(v)
            return v

        def plain_call(steps=plain_steps, inputs=inputs):
            v = dict(inputs)
            for step in steps:
                step(v)
            return v

        got = kernel_call()[out]
        if not torch.equal(got, plain_call()[out]) or not torch.equal(got, vals[out]):
            fail(f"int8 conv op {k} ({op.name}{' + ADD' if add else ''}): the kernel differs "
                 "from the plain step")
        xin, w = vals[op.inputs[0]], graph.tensors[op.inputs[1]].data
        n_bytes = xin.numel() + got.numel() * (2 if add else 1) + w.size
        depthwise = op.name == "DEPTHWISE_CONV_2D"
        wf = torch.from_numpy(np.transpose(w, (3, 0, 1, 2) if depthwise else (0, 3, 1, 2)))
        wf = wf.float().cuda()
        xf = xin.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pad = tuple(n // 2 for n in w.shape[1:3]) if op.options["padding"] == "SAME" else 0

        def library_call(xf=xf, wf=wf, pad=pad, op=op, groups=xin.shape[3] if depthwise else 1):
            return F.conv2d(xf, wf, stride=op.options["strides"], padding=pad, groups=groups)

        row = {"op": k, "name": op.name + ("+ADD" if add else ""),
               "kernel": kernels[op.outputs[0]], "in": list(xin.shape), "out": list(got.shape),
               "ms": per_call_ms(kernel_call), "plain_ms": per_call_ms(plain_call),
               "library_ms": per_call_ms(library_call),
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        row["fraction_of_bound"] = row["bound_ms"] / row["ms"] if row["ms"] else None
        rows.append(row)
        for key in totals:
            totals[key] += row[key] or 0.0
            sums[row["kernel"]][key] += row[key] or 0.0
    print(json.dumps({"int8_conv_kernels_b64": rows, "body_totals": totals, "card": card()}))
    entries = []
    for name, (n, ms) in served.items():
        entries.append({"name": name, "route": "cuda", "source": INT8_CONV_SOURCE,
                        "replaces": None, "launches": n, "max_abs_err": 0.0, "ms": ms,
                        "isolated_ms": sums[name]["ms"], "plain_ms": sums[name]["plain_ms"],
                        "bound_ms": sums[name]["bound_ms"], "bound_by": "bytes",
                        "fraction_of_bound": sums[name]["bound_ms"] / ms,
                        "library_ms": sums[name]["library_ms"],
                        "served_path": "INT8 leg: TFLiteSimRunner.forward_block, graph replay"})
    return entries


def cosine(np, a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def write_serve_files(np, root: Path) -> None:
    """SERVE_FILES from seeded chirps: PCM16 mono through the port's
    save_wav, stereo and float32 through `wave` and a RIFF header."""
    import struct
    import wave

    from birdnet_stm32_tpu_torch.audio.io import save_wav

    rng = np.random.default_rng(1)
    for name, sr, seconds, channels, fmt in SERVE_FILES:
        t = np.arange(int(sr * seconds)) / sr
        f0 = rng.uniform(800.0, 5000.0, (channels, 1))
        x = 0.5 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.03 * t)) + rng.normal(0, 0.05, (channels, t.size))
        x = np.clip(x, -1.0, 1.0).astype(np.float32).T  # [T, C]
        path = root / name
        if fmt == "float32":
            data = x.astype("<f4").tobytes()
            fmt_chunk = struct.pack("<HHIIHH", 3, channels, sr, sr * 4 * channels, 4 * channels, 32)
            body = (b"WAVEfmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk + b"data"
                    + struct.pack("<I", len(data)) + data)
            path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
        elif channels == 1:
            save_wav(x[:, 0], path, sr)
        else:
            with wave.open(str(path), "wb") as w:
                w.setnchannels(channels)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes((x * 32767.0).astype("<i2").tobytes())


def run_verb(verb: str, args: list[str]) -> str:
    """`python -m birdnet_stm32_tpu_torch <verb> ...` in this process; its
    standard output."""
    import contextlib
    import io

    from birdnet_stm32_tpu_torch.__main__ import main as port_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main([verb, *args])
    if rc != 0:
        fail(f"{verb} {args} exited {rc}:\n{out.getvalue()[-2000:]}")
    return out.getvalue()



def tsv_rows(np, path: Path) -> dict:
    rows = {}
    for line in path.read_text().splitlines():
        if line:
            name, *vals = line.split("\t")
            rows[name] = (line, np.array([float(v) for v in vals]))
    return rows


def raw_pcm16_batch(np, cfg, n: int):
    """(int16 [n, T+1] raw codes + peak column, the host's float32 [n, T])
    from seeded chirps: what load_chunks_int16 and load_audio_window make of
    a mono PCM16 file at the model rate. Even rows peak at 32768."""
    wave = requests_for(np, cfg, (n,))[0]
    codes = np.clip(np.round(wave / np.abs(wave).max() * 32767.0), -32768, 32767).astype(np.int16)
    codes[::2, 0] = -32768
    peak = np.abs(codes.astype(np.int32)).max(axis=1)
    scale = np.where(peak < 32768, peak, -32768).astype(np.int16)[:, None]
    floats = (codes.astype(np.float32) / np.float32(32768.0)
              / (peak.astype(np.float32)[:, None] / np.float32(32768.0)))
    return np.concatenate([codes, scale], axis=1), floats


def serve_cli_checks(np, root: Path, launches: dict) -> None:
    """The CLI in the four SERVE_MODES on CUDA with the committed bundle:
    rows, launches, the int16 / mu-law / device-resample gates, resume."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.serving import decode_for_classify
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    audio = root / "audio"
    audio.mkdir()
    write_serve_files(np, audio)
    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    linear = frontend_kernel.kernel_name("linear", "none")
    rows = {}
    for mode, extra in SERVE_MODES.items():
        # One 64-chunk batch per file (each file is under 64 chunks).
        n_batches = sum(-(-len(decode_for_classify(
            audio / f[0], cfg, device_resample=mode == "device_resample")[0]) // B)
            for f in SERVE_FILES)
        results = root / f"{mode}.tsv"
        args = ["--model_path", str(FLAGSHIP_TFLITE), "--audio_dir", str(audio),
                "--results_file", str(results), "--once", *extra]
        frontend_kernel.launches.clear()
        t0 = time.perf_counter()
        out = run_verb("serve", args)
        wall = time.perf_counter() - t0
        counts = dict(frontend_kernel.launches)
        launches[f"serve --{mode}"] = counts.get(linear, 0)
        rows[mode] = tsv_rows(np, results)
        again = run_verb("serve", args)
        print(json.dumps({"serve_mode": mode, "files": len(rows[mode]), "batches": n_batches,
                          "kernel_launches": counts, "serve_wall_s": wall,
                          "second_run": again.strip().splitlines()[-1]}))
        if counts != {linear: n_batches}:
            fail(f"serve {mode}: launches {counts}, expected {linear} x {n_batches} only")
        if sorted(rows[mode]) != sorted(f[0] for f in SERVE_FILES):
            fail(f"serve {mode}: rows for {sorted(rows[mode])}")
        for name, (_, v) in rows[mode].items():
            if v.shape != (cfg.num_classes,) or not np.isfinite(v).all():
                fail(f"serve {mode}: {name} has {v.shape} scores, finite {np.isfinite(v).all()}")
        if "files served: 0" not in again:
            fail(f"serve {mode}: the second run did not resume: {again[-300:]}")
    f = rows["float"]
    report = {}
    for name, _, _, channels, fmt in SERVE_FILES:
        a = f[name][1]
        u, d = rows["ulaw"][name][1], rows["device_resample"][name][1]
        report[name] = {"int16_line_equal": rows["int16"][name][0] == f[name][0],
                        "ulaw_cosine": cosine(np, u, a), "ulaw_max_abs": float(np.abs(u - a).max()),
                        "device_resample_cosine": cosine(np, d, a)}
    print(json.dumps({"serve_vs_float_ingress": report}))
    for name, sr, _, channels, fmt in SERVE_FILES:
        r = report[name]
        if sr == cfg.sample_rate and channels == 1 and fmt == "pcm16" and not r["int16_line_equal"]:
            fail(f"serve --int16_io: {name} (raw PCM16 codes) differs from float ingress")
        if not (r["ulaw_cosine"] > ULAW_MIN_COSINE and r["ulaw_max_abs"] <= ULAW_MAX_ABS):
            fail(f"serve --ulaw_io: {name} outside the JAX gate: {r}")
        if not r["device_resample_cosine"] >= FEED_MIN_COSINE:
            fail(f"serve --device_resample: {name} cosine {r['device_resample_cosine']}")


def serve_api_checks(torch, np, launches: dict) -> None:
    """The float leg (hybrid, full width, seeded weights) and the fixture's
    fused int8-entry leg through make_fused_classifier on CUDA."""
    from birdnet_stm32_tpu_torch.audio.io import fast_resample
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from tests.int8_fixture import entry_transpose_fixture

    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    runner = TorchRunner(init_model(build_dscnn(cfg, device="cuda"), seed=0), cfg, device="cuda")
    w16, floats = raw_pcm16_batch(np, cfg, 8)
    checks = {}
    f = make_fused_classifier(runner, cfg, device="cuda")(floats)
    i = make_fused_classifier(runner, cfg, input_dtype="int16", device="cuda")(w16)
    checks["float_leg_int16_bit_equal"] = bool(np.array_equal(i, f))
    errs = {}
    for sr in (48000, 16000):
        wave = np.random.default_rng(sr).normal(0, 0.2, (4, int(cfg.chunk_duration * sr)))
        wave = wave.astype(np.float32)
        native = make_fused_classifier(runner, cfg, input_sample_rate=sr, device="cuda")(wave)
        host = np.stack([fast_resample(w, sr, cfg.sample_rate) for w in wave])
        host = make_fused_classifier(runner, cfg, device="cuda")(host[:, :cfg.chunk_samples])
        errs[sr] = float(np.abs(native - host).max())
        checks[f"float_leg_resample_{sr}"] = bool(np.allclose(native, host, atol=1e-5, rtol=1e-4))
    fixture = TFLiteSimRunner(entry_transpose_fixture(TFLiteSimRunner(
        FLAGSHIP_TFLITE, device="cuda").graph), device="cuda")
    frontend_kernel.launches.clear()
    i = make_fused_classifier(fixture, cfg, input_dtype="int16", device="cuda")(w16)
    int8_name = frontend_kernel.kernel_name("linear", "none", quant=True)
    launches["serve API, int16 ingress, fused int8 entry"] = frontend_kernel.launches[int8_name]
    f = make_fused_classifier(fixture, cfg, device="cuda")(floats)
    checks["fused_int8_leg_int16_bit_equal"] = bool(np.array_equal(i, f))
    print(json.dumps({"serve_api_checks": checks, "resample_vs_host_max_abs": errs}))
    for check, ok in checks.items():
        if not ok:
            fail(f"serve API check {check} failed")


def serve_card_checks(torch, np) -> None:
    """On the card: _dequantize_int16 over the whole int16 code x scale
    domain, the mu-law decoder on all codes, the resampler against the CPU."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.serving import _dequantize_int16, _dequantize_ulaw
    from birdnet_stm32_tpu_torch.ops.resample import resample_chunk_batch

    t0 = time.perf_counter()
    codes = torch.arange(-32768, 32768, device="cuda", dtype=torch.int32).to(torch.int16)
    scales = torch.cat([torch.arange(1, 32768, device="cuda", dtype=torch.int32),
                        torch.tensor([-32768, 0], device="cuda", dtype=torch.int32)])
    w = torch.empty(512, codes.numel() + 1, dtype=torch.int16, device="cuda")
    w[:, :-1] = codes
    n = 0
    for lo in range(0, scales.numel(), 512):
        s = scales[lo : lo + 512]
        ws = w[: s.numel()]
        ws[:, -1] = s.to(torch.int16)
        # float64 division rounded to float32 is the correctly rounded
        # float32 quotient for these operands (no double-rounding tie).
        ref = (codes.double()[None] / s.double().abs().clamp_min(1.0)[:, None]).float()
        if not torch.equal(_dequantize_int16(ws).view(torch.int32), ref.view(torch.int32)):
            fail(f"_dequantize_int16 on the card differs from IEEE division at scales {lo}..")
        n += ws[:, :-1].numel()
    domain_s = time.perf_counter() - t0
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)[None]
    ulaw_err = (_dequantize_ulaw(q.cuda()).cpu() - _dequantize_ulaw(q)).abs().max().item()
    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    resample_errs = {}
    for sr in RESAMPLE_RATES:
        x = torch.from_numpy(np.random.default_rng(sr).normal(0, 0.3, (B, 3 * sr)).astype(np.float32))
        got = resample_chunk_batch(x.cuda(), sr, cfg)
        torch.cuda.synchronize()
        resample_errs[sr] = (got.cpu() - resample_chunk_batch(x, sr, cfg)).abs().max().item()
    print(json.dumps({"int16_dequant_quotients_bit_equal": n, "int16_domain_s": domain_s,
                      "ulaw_card_vs_cpu_max_abs": ulaw_err,
                      "resample_card_vs_cpu_max_abs": resample_errs}))
    if n != 65536 * 32769:
        fail(f"int16 domain: {n} quotients checked, expected {65536 * 32769}")
    if not ulaw_err <= 2e-7:
        fail(f"mu-law decoder: card vs CPU {ulaw_err} > 2e-7")
    for sr, err in resample_errs.items():
        if not err <= 2e-5:
            fail(f"resampler {sr} -> {cfg.sample_rate}: card vs CPU {err} > 2e-5")


def serve_breakdown(torch, np, rounds: int = 3) -> None:
    """One warm 64-chunk batch per ingress mode on both legs, by part (CUDA
    events): host-to-device copy, dequant (+ resample), frontend, model,
    whole classify call; the modes in turns, `rounds` times, and the median
    of each part."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import (
        make_fused_classifier,
        make_ingress,
        quantize_waveform_ulaw,
    )
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input

    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    w16, floats = raw_pcm16_batch(np, cfg, B)
    wave48 = np.random.default_rng(48).normal(0, 0.2, (B, 3 * 48000)).astype(np.float32)
    batches = {"float32": (None, None, floats), "int16": ("int16", None, w16),
               "ulaw": ("ulaw", None, quantize_waveform_ulaw(floats)),
               "float32_48k_resample": (None, 48000, wave48)}
    legs = {"float": TorchRunner(init_model(build_dscnn(cfg, device="cuda"), seed=0), cfg,
                                 device="cuda"),
            "int8": TFLiteSimRunner(FLAGSHIP_TFLITE, device="cuda")}
    for leg, runner in legs.items():
        runs = {mode: [] for mode in batches}
        for _ in range(rounds):
            for mode, (dtype, rate, host) in batches.items():
                ingress = make_ingress(cfg, rate, dtype)
                classify = make_fused_classifier(runner, cfg, input_sample_rate=rate,
                                                 input_dtype=dtype, device="cuda")
                with torch.no_grad():
                    x = torch.as_tensor(host).cuda()
                    w = ingress(x)
                    feats = frontend_input(w, cfg)
                    runs[mode].append({
                        "h2d_copy": cuda_ms(torch, lambda: torch.as_tensor(host).cuda()),
                        "ingress": cuda_ms(torch, lambda: ingress(x)) if dtype or rate else 0.0,
                        "frontend_kernel": cuda_ms(torch, lambda: frontend_input(w, cfg)),
                        "model": cuda_ms(torch, lambda: runner.forward_block(feats)),
                        "classify_total": cuda_ms(torch, lambda: classify(host)),
                    })
        report = {mode: {"h2d_bytes": batches[mode][2].nbytes,
                         **{part: float(np.median([r[part] for r in rs])) for part in rs[0]},
                         "classify_total_by_round": [r["classify_total"] for r in rs]}
                  for mode, rs in runs.items()}
        print(json.dumps({"serve_leg": leg, "rounds": rounds,
                          "batch_breakdown_median_ms": report}))


def serve_phase(torch, np) -> dict:
    """The port's `serve` entry point and its ingress; returns the linear
    kernels' launches by path."""
    import tempfile

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        serve_cli_checks(np, Path(tmp), launches)
    serve_api_checks(torch, np, launches)
    serve_card_checks(torch, np)
    serve_breakdown(torch, np)
    return launches


# The bf16 gate of bench.py's headline (mean score cosine >= 0.999 against
# float32) and the port's gate for its CPU bf16 path on BF16_CPU_ROWS rows.
BF16_MIN_COSINE = 0.999
BF16_CPU_ROWS = 8
# The kernel phase's tolerance of a kernel against its plain version, by
# kernel (1e-5 for linear, 2e-5 for the others).
KERNEL_TOL = {"linear": 1e-5}
FEATURE_TOL = 2e-5


def row_cosines(np, a, b):
    """Per-row cosine of two score batches (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def bf16_phase(torch, np, cfg) -> dict[str, int]:
    """The bf16 leg at full width (the flagship, seeded init_model): 229
    chunks in batches of 3 x 64 + 37 through make_fused_classifier with a
    TorchRunner(dtype=torch.bfloat16), against the float32 leg on the same
    waveforms and the port's CPU bf16 path; then one 64-chunk batch of each
    leg by part. Returns the linear kernel's launches on the bf16 run."""
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        make_fused_classifier,
    )
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    model = init_model(build_dscnn(cfg, device="cuda"), seed=0)
    legs = {"fp32": TorchRunner(model, cfg, device="cuda"),
            "bf16": TorchRunner(model, cfg, device="cuda", dtype=torch.bfloat16)}
    dtypes = {p.dtype for p in legs["bf16"].model.parameters()} | {
        b.dtype for b in legs["bf16"].model.buffers() if b.is_floating_point()}
    if dtypes != {torch.bfloat16}:
        fail(f"bf16 runner holds {dtypes}")
    classify = {leg: make_fused_classifier(r, cfg, device="cuda") for leg, r in legs.items()}
    requests = requests_for(np, cfg, REQUESTS)
    n_chunks, n_batches = sum(REQUESTS), sum(-(-n // B) for n in REQUESTS)
    name = frontend_kernel.kernel_name("linear", "none")

    frontend_kernel.launches.clear()
    t0 = time.perf_counter()
    results = [classify_in_batches(classify["bf16"], r, batch_size=B) for r in requests]
    wall = time.perf_counter() - t0
    counts = dict(frontend_kernel.launches)
    s16 = np.concatenate([sc for sc, _ in results])
    s32 = np.concatenate([classify_in_batches(classify["fp32"], r, batch_size=B)[0]
                          for r in requests])
    cos = row_cosines(np, s16, s32)
    cpu_model = build_dscnn(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu16 = make_fused_classifier(TorchRunner(cpu_model, cfg, device="cpu",
                                              dtype=torch.bfloat16), cfg, device="cpu")
    cpu_cos = row_cosines(np, cpu16(requests[0][:BF16_CPU_ROWS]), s16[:BF16_CPU_ROWS])
    print(json.dumps({"bf16_leg": "flagship", "served_chunks": n_chunks, "batches": n_batches,
                      "kernel_launches": counts, "serve_wall_s": wall,
                      "request_seconds": [dt for _, dt in results],
                      "mean_cosine_vs_fp32": float(cos.mean()),
                      "min_cosine_vs_fp32": float(cos.min()),
                      "max_abs_vs_fp32": float(np.abs(s16 - s32).max()),
                      "min_cosine_vs_cpu_bf16": float(cpu_cos.min()),
                      "top1_agreement_vs_fp32": float((s16.argmax(1) == s32.argmax(1)).mean())}))
    if counts != {name: n_batches}:
        fail(f"bf16 leg: launches {counts}, expected {name} x {n_batches} only")
    if s16.shape != (n_chunks, cfg.num_classes) or not np.isfinite(s16).all():
        fail(f"bf16 leg: scores {s16.shape} not finite [{n_chunks}, {cfg.num_classes}]")
    if not cos.mean() >= BF16_MIN_COSINE:
        fail(f"bf16 leg: mean cosine {cos.mean()} vs fp32 < {BF16_MIN_COSINE}")
    if not cpu_cos.min() >= BF16_MIN_COSINE:
        fail(f"bf16 leg: cosine {cpu_cos.min()} vs the CPU bf16 path < {BF16_MIN_COSINE}")

    # One warm 64-chunk batch by part, the legs in turns, median of three
    # rounds (CUDA events).
    wave = torch.from_numpy(requests[0])
    x = wave.cuda()
    with torch.no_grad():
        feats = frontend_kernel.frontend_input(x, cfg)
        feats16 = feats.to(torch.bfloat16)
    parts = {leg: [] for leg in legs}
    for _ in range(3):
        for leg, runner in legs.items():
            f_in = feats16 if leg == "bf16" else feats
            with torch.no_grad():
                parts[leg].append({
                    "h2d_copy": cuda_ms(torch, lambda: wave.cuda()),
                    "frontend_kernel": cuda_ms(torch, lambda: frontend_kernel.frontend_input(
                        x, cfg)),
                    "bf16_cast": (cuda_ms(torch, lambda: feats.to(torch.bfloat16))
                                  if leg == "bf16" else 0.0),
                    "dscnn_forward": cuda_ms(torch, lambda: runner.forward(f_in)),
                    "classify_total": cuda_ms(torch, lambda: classify[leg](requests[0])),
                })
    print(json.dumps({"bf16_batch_breakdown_median_ms": {
        leg: {part: float(np.median([r[part] for r in rs])) for part in rs[0]}
        for leg, rs in parts.items()}, "rounds": 3}))
    return {name: counts[name]}


# The fuzz configs' float32 logits card vs CPU, as a share of each row's
# spread (tests/torch_fuzz_fixtures.py::spread_error): cuDNN's and the
# CPU's convolutions sum in other orders. The gate is 10x the port-vs-JAX
# gate on the CPU (LOGIT_SPREAD_RTOL, 1e-4), as test_fuzz_configs_on_card
# holds it; the phase prints each config's reading.
FUZZ_LOGIT_RTOL = 1e-3


def fuzz_phase(torch, np) -> dict[str, int]:
    """The nine fuzz configurations (tests/goldens/torch_fuzz, made by
    tests/make_torch_fuzz_fixtures.py with the JAX package): the CUDA
    executor against the JAX goldens (requant exact and fast), the float
    leg in float32 and bf16 against the JAX scores, and each config's
    waveform -> scores path through make_fused_classifier. Returns the
    kernels' launches on the waveform paths."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
    from tests.torch_fuzz_fixtures import (
        MIN_EXACT_SHARE,
        ONE_QUANTUM,
        all_fixtures,
        has_float_faithful_ops,
        spread_error,
        within_one_quantum,
    )

    launches: dict[str, int] = {}
    for f in all_fixtures():
        cfg = ModelConfig.from_dict(f.cfg)
        graph = TFLiteGraph(f.tflite)
        feats = torch.from_numpy(f.features).cuda()
        report = {"fuzz_config": f.label}
        for requant, ref in (("exact", f.int8_exact), ("fast", f.int8_fast)):
            got = build_executor(graph, len(f.features), device="cuda",
                                 requant=requant)(feats).cpu().numpy()
            err, exact = within_one_quantum(got, ref)
            report[f"int8_{requant}"] = {"max_abs": err, "exact_share": exact}
            if exact < 1.0:
                if not (has_float_faithful_ops(graph) and err <= ONE_QUANTUM
                        and exact >= MIN_EXACT_SHARE):
                    fail(f"fuzz {f.label}: CUDA executor ({requant}) off the JAX golden: "
                         f"max {err}, {exact:.2%} exact")
                report[f"int8_{requant}"]["softmax_ulp_graph"] = True

        model = build_dscnn(cfg, class_activation=f.class_activation, device="cuda")
        model.load_state_dict(flax_to_state_dict(f.variables), strict=True)
        r32 = TorchRunner(model, cfg, device="cuda")
        r16 = TorchRunner(model, cfg, device="cuda", dtype=torch.bfloat16)
        f32_err = float(np.abs(r32.predict(f.features) - f.float_f32).max())
        bf16_cos = float(row_cosines(np, r16.predict(f.features), f.float_bf16).min())
        logits = {}
        for dev in ("cuda", "cpu"):
            m = build_dscnn(cfg, class_activation="none", device=dev)
            m.load_state_dict(flax_to_state_dict(f.variables), strict=True)
            logits[dev] = TorchRunner(m, cfg, device=dev).predict(f.features)
        logit_err = spread_error(logits["cuda"], logits["cpu"])
        report.update(float_f32_max_abs=f32_err, bf16_min_cosine_vs_jax=bf16_cos,
                      f32_logits_spread_err_card_vs_cpu=logit_err)
        if not f32_err <= 1e-5:
            fail(f"fuzz {f.label}: float32 scores {f32_err} from the JAX golden > 1e-5")
        if not bf16_cos >= BF16_MIN_COSINE:
            fail(f"fuzz {f.label}: bf16 cosine {bf16_cos} vs the JAX bf16 golden")
        if not logit_err <= FUZZ_LOGIT_RTOL:
            fail(f"fuzz {f.label}: float32 logits card vs CPU {logit_err} of the row spread "
                 f"> {FUZZ_LOGIT_RTOL}")

        # The waveform -> scores path on CUDA, counted from zero.
        mode = frontend_kernel.FRONTEND_MODES.get(cfg.audio_frontend)
        kname = (frontend_kernel.kernel_name(mode, cfg.mag_scale if mode == "mel" else "none")
                 if mode else None)
        x = torch.from_numpy(f.waves).cuda()
        frontend_kernel.launches.clear()
        with torch.no_grad():
            wave_feats = frontend_kernel.frontend_input(x, cfg).cpu().numpy()
        legs = {"fp32": r32, "bf16": r16,
                "int8": TFLiteSimRunner(graph, device="cuda")}
        scores = {leg: make_fused_classifier(r, cfg, device="cuda")(f.waves)
                  for leg, r in legs.items()}
        counts = dict(frontend_kernel.launches)
        expected = {kname: 1 + len(legs)} if kname else {}
        feat_tol = KERNEL_TOL.get(mode, FEATURE_TOL) if kname else 1e-6
        feat_err = float(np.abs(wave_feats - f.wave_features).max())
        cpu_int8 = make_fused_classifier(TFLiteSimRunner(graph, device="cpu"), cfg,
                                         device="cpu")(f.waves)
        int8_cos = float(row_cosines(np, scores["int8"], cpu_int8).min())
        wave_bf16_cos = float(row_cosines(np, scores["bf16"], scores["fp32"]).min())
        report.update(kernel=kname, kernel_launches=counts,
                      wave_features_max_abs_vs_jax=feat_err,
                      wave_int8_min_cosine_vs_cpu=int8_cos,
                      wave_bf16_min_cosine_vs_fp32=wave_bf16_cos)
        print(json.dumps(report))
        if counts != expected:
            fail(f"fuzz {f.label}: launches {counts}, expected {expected}")
        if not feat_err <= feat_tol:
            fail(f"fuzz {f.label}: waveform features {feat_err} from JAX's > {feat_tol}")
        if not int8_cos >= BF16_MIN_COSINE:
            fail(f"fuzz {f.label}: INT8 cosine {int8_cos} vs the CPU path")
        if not wave_bf16_cos >= BF16_MIN_COSINE:
            fail(f"fuzz {f.label}: bf16 cosine {wave_bf16_cos} vs fp32 on waveforms")
        for leg, sc in scores.items():
            if sc.shape != (len(f.waves), cfg.num_classes) or not np.isfinite(sc).all():
                fail(f"fuzz {f.label}: {leg} scores {sc.shape} not finite")
        if kname:
            launches[kname] = launches.get(kname, 0) + counts[kname]
    return launches


def prepass_phase(torch, np) -> None:
    """The executor's steps and CUDA launches per 64-chunk batch on the
    flagship graph with and without the layout pre-passes (the same
    scores)."""
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
    from tests.int8_fixture import flagship_features

    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    x = torch.from_numpy(flagship_features(B)).cuda()
    out, report = {}, {}
    for pre in (False, True):
        fwd = build_executor(graph, B, device="cuda", layout_prepasses=pre)
        out[pre] = fwd(x).cpu().numpy()
        report["with_prepasses" if pre else "without_prepasses"] = {
            "ops": len(graph.ops), "steps": fwd.steps, "executor_ms": cuda_ms(torch, lambda: fwd(x)),
            **device_activity(torch, lambda: fwd(x))}
    print(json.dumps({"executor_prepasses_flagship_b64": report}))
    if not np.array_equal(out[False], out[True]):
        fail("the layout pre-passes changed the flagship graph's scores")


# The train phase's seeded WAV folder is
# tests/make_torch_convert_fixtures.py::write_train_folder's.
TRAIN_BATCH = 64
TRAIN_STEPS = 8
# The card-vs-CPU train step: STEP_ROWS rows of the FIFO batch. Both steps
# train on the card's features (the kernel is held to its plain version
# on its own), so the gates measure the step alone: cuDNN's and the CPU's
# convolutions and BN backward sum in other orders. A BN bias's or
# scale's gradient is a sum over the batch of terms that nearly cancel
# (the next train-mode BN's backward takes out their mean), so those
# tensors keep fewer correct digits than the loss. Readings on an H100
# 80GB HBM3 at 700 W on this batch: loss 9.9e-8, gradient norm 2.0e-4, BN
# statistics 2.8e-7, the worst tensor's update (stage1_ds2_pw_bn.bias)
# 1.9 % and the whole update 0.55 % in L2 norm, all relative; the gates
# stand 2.5-35x above them.
STEP_ROWS = 16
STEP_LOSS_RTOL = 1e-6
STEP_GRAD_NORM_RTOL = 1e-3
STEP_TENSOR_UPDATE_RTOL = 5e-2
STEP_UPDATE_RTOL = 2e-2
STEP_STATS_RTOL = 1e-5


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def loader_args(data: Path, workers: int):
    """cli/train.py::build_loaders' arguments for the train folder: the
    flagship's rate and chunk, batch TRAIN_BATCH, the CLI's defaults."""
    from types import SimpleNamespace

    return SimpleNamespace(
        seed=0, data_path_train=str(data), data_path_val=None, val_split=0.2,
        top_n_classes=None, max_samples_per_class=None, upsample_ratio=0.5,
        no_upsample=False, sample_rate=22050, chunk_duration=3.0, max_chunks_per_file=2,
        snr_threshold=0.1, max_duration=30.0, batch_size=TRAIN_BATCH, num_workers=workers)


def train_args(data: Path, run_dir: Path, epochs: int, steps: int = TRAIN_STEPS,
               workers: str = "4") -> list[str]:
    """The flagship's full width (hybrid, pwl, n_fft 512, 64 mels, 256
    frames, alpha 1.0, embeddings 256, plain DS blocks, no SE) with the
    defaults otherwise: int16 feed, mixup, SpecAugment, 4 loader workers
    (`workers`)."""
    return ["--data_path_train", str(data), "--run_dir", str(run_dir),
            "--sample_rate", "22050", "--chunk_duration", "3.0", "--fft_length", "512",
            "--num_mels", "64", "--spec_width", "256", "--audio_frontend", "hybrid",
            "--mag_scale", "pwl", "--alpha", "1.0", "--embeddings_size", "256",
            "--no_se", "--no_inverted_residual", "--batch_size", str(TRAIN_BATCH),
            "--epochs", str(epochs), "--steps_per_epoch", str(steps), "--seed", "0",
            "--num_workers", workers]


def counted(seen: dict, key: str, batches):
    """Yield from `batches`, counting them in seen[key]."""
    for b in batches:
        seen[key] = seen.get(key, 0) + 1
        yield b


def run_train(torch, args: list[str], seen: dict) -> None:
    """`python -m birdnet_stm32_tpu_torch train ...` in this process on
    CUDA (the default device), with train_model wrapped to record, over
    every call (a tuning run makes one per trial): the devices and dtypes
    of the model's parameters and of the batcher's tensors, the batcher's
    calls ("steps") and the validation batches ("val"), the stem
    convolution's input and weight dtypes, each step's loss and each
    call's history."""
    import contextlib
    import io

    from birdnet_stm32_tpu_torch.__main__ import main as port_main
    from birdnet_stm32_tpu_torch.training import trainer

    real, real_step = trainer.train_model, trainer.make_train_step

    def spy(model, cfg, train_batches, val_batches, run_dir, batcher=None, **kw):
        def spy_batcher(gen, wave, labels):
            x, y = batcher(gen, wave, labels)
            seen.setdefault("batch", set()).update(
                (t.device.type, str(t.dtype)) for t in (wave, x, y))
            seen["steps"] = seen.get("steps", 0) + 1
            return x, y

        hook = model.stem_conv.register_forward_pre_hook(
            lambda m, a: seen.setdefault("stem", set()).add((str(a[0].dtype), str(m.weight.dtype))))
        try:
            out = real(model, cfg, train_batches, lambda: counted(seen, "val", val_batches()),
                       run_dir, batcher=spy_batcher, **kw)
        finally:
            hook.remove()
        seen["params"] = {p.device.type for p in model.parameters()}
        seen["param_dtypes"] = {str(p.dtype) for p in model.parameters()}
        seen.setdefault("histories", []).append(out[1])
        return out

    def spy_step(*a, **k):
        step = real_step(*a, **k)

        def step_and_record(state, x, y):
            state, metrics = step(state, x, y)
            seen.setdefault("step_losses", []).append(metrics["loss"])
            return state, metrics

        return step_and_record

    trainer.train_model, trainer.make_train_step = spy, spy_step
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = port_main(["train", *args])
    finally:
        trainer.train_model, trainer.make_train_step = real, real_step
    if rc != 0:
        fail(f"train {args} exited {rc}:\n{out.getvalue()}")
    seen["stdout"] = out.getvalue()


def train_step_check(torch, cfg, wave, labels, qat: bool = False,
                     state_dict: dict | None = None) -> None:
    """One train step from the same state and int16 batch (STEP_ROWS rows),
    the card against the port's CPU path: dropout 0, no augmentation, SGD,
    the L2 term on. qat=True takes the QAT step (quant/qat.py) from
    `state_dict` (a trained run's weights: its BN statistics are what the
    frozen BN runs on)."""
    import copy

    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
    from birdnet_stm32_tpu_torch.quant.qat import make_qat_train_step
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer

    make_step = make_qat_train_step if qat else make_train_step
    wave, labels = wave[:STEP_ROWS], labels[:STEP_ROWS]
    batcher = make_train_batcher(cfg, spec_augment=False, mixup_probability=0.0,
                                 input_dtype="int16")
    # The batch through the batcher on both sides (the kernel against its
    # plain version); both steps then train on the card's features, so the
    # step gates measure the step alone.
    xg, yg = batcher(None, torch.as_tensor(wave).cuda(), torch.as_tensor(labels).cuda())
    xc, _ = batcher(None, torch.as_tensor(wave), torch.as_tensor(labels))
    gpu = init_model(build_dscnn(cfg, class_activation="none", device="cuda"), seed=3)
    if state_dict is not None:
        gpu.load_state_dict(state_dict, strict=True)
    res = {}
    for dev, model in (("cuda", gpu), ("cpu", copy.deepcopy(gpu).to("cpu"))):
        for m in model.modules():
            if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
                m.p = 0.0
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tx = build_optimizer("sgd", 1e-2, gradient_clip_norm=1.0)
        step = make_step(model, tx, make_loss_fn(multilabel=True))
        _, metrics = step(TrainState.create(model, tx), xg.to(dev), yg.to(dev))
        after = model.state_dict()
        res[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: (after[k] - before[k]).cpu() for k in after if after[k].is_floating_point()},
                    {k: v.cpu() for k, v in after.items() if "running" in k})
    (mg, ug, sg), (mc, uc, sc) = res["cuda"], res["cpu"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    moved = [k for k in uc if "running" not in k and uc[k].norm() > 0]
    per_tensor = {k: float((ug[k] - uc[k]).norm() / uc[k].norm()) for k in moved}
    worst = sorted(per_tensor, key=per_tensor.get, reverse=True)[:3]
    diff = torch.cat([(ug[k] - uc[k]).flatten() for k in moved])
    got = {
        "features_max_abs": float((xg.cpu() - xc).abs().max()),
        "loss_rel": rel(mg["loss"], mc["loss"]),
        "grad_norm_rel": rel(mg["grad_norm"], mc["grad_norm"]),
        "tensor_update_rel": per_tensor[worst[0]],
        "update_rel": float(diff.norm() / torch.cat([uc[k].flatten() for k in moved]).norm()),
        "bn_stats_rel": max(float((sg[k] - sc[k]).abs().max() / sc[k].abs().max().clamp_min(1e-30))
                            for k in sc),
    }
    label = "qat_step_card_vs_cpu" if qat else "train_step_card_vs_cpu"
    print(json.dumps({label: got, "rows": STEP_ROWS,
                      "worst_tensors": {k: per_tensor[k] for k in worst}}))
    gates = {"features_max_abs": KERNEL_TOL["linear"], "loss_rel": STEP_LOSS_RTOL,
             "grad_norm_rel": STEP_GRAD_NORM_RTOL, "tensor_update_rel": STEP_TENSOR_UPDATE_RTOL,
             "update_rel": STEP_UPDATE_RTOL, "bn_stats_rel": STEP_STATS_RTOL}
    for k, tol in gates.items():
        if not got[k] <= tol:
            fail(f"{label}: {k} {got[k]:.3e} > {tol:.0e}")


def features_train_check(torch, np, flagship, wave, labels, tmp: Path,
                         key: str = "train_librosa_pwl", **train_kw) -> int:
    """train_model (the API under `train`) on the librosa + pwl config at
    full width, whose features come from the features kernel: two train
    steps on one int16 loader batch with SpecAugment and mixup, and one
    validation batch; train_kw picks the step (qat=, qat_act=). The kernel
    launches once per step and per validation batch, and nothing else
    launches; returns its launches."""
    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.training.trainer import train_model

    cfg = dataclasses.replace(flagship, audio_frontend="librosa", mag_scale="pwl")
    deq = wave[:, :-1].astype(np.float32) / np.abs(wave[:, -1:].astype(np.float32))
    model = init_model(build_dscnn(cfg, class_activation="none", device="cuda"), seed=5)
    name = frontend_kernel.kernel_name("mel", "pwl")
    frontend_kernel.launches.clear()
    _, history = train_model(
        model, cfg, iter([(wave, labels)] * 2), lambda: [(deq, labels)], tmp / key,
        epochs=1, steps_per_epoch=2, batcher=make_train_batcher(cfg, input_dtype="int16"),
        multilabel=True, device="cuda", **train_kw)
    counts = dict(frontend_kernel.launches)
    if counts != {name: 3} or not np.isfinite(history[0]["loss"]):
        fail(f"librosa + pwl training ({key}): launches {counts} (want {{{name!r}: 3}}), "
             f"history {history}")
    print(json.dumps({key: {"launches": counts[name], "loss": history[0]["loss"]}}))
    return counts[name]


def train_timing(torch, cfg, wave, labels) -> dict:
    """One int16 batch of TRAIN_BATCH: the batcher (dequant, the kernel,
    SpecAugment, mixup) and the train step (adam) on the card, each the
    median of seven CUDA-event timings after two warm-up calls, and the
    CUDA launches and device-busy ms of one call of each (torch.profiler)."""
    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer
    from birdnet_stm32_tpu_torch.utils.prng import generator

    wave, labels = torch.as_tensor(wave).cuda(), torch.as_tensor(labels).cuda()
    batcher = make_train_batcher(cfg, input_dtype="int16")
    model = init_model(build_dscnn(cfg, class_activation="none", device="cuda"), seed=4)
    tx = build_optimizer("adam", 1e-3, gradient_clip_norm=1.0)
    step = make_train_step(model, tx, make_loss_fn(multilabel=True))
    state = TrainState.create(model, tx)
    gen = generator(0, "cuda")
    x, y = batcher(gen, wave, labels)
    batcher_ms = cuda_ms_median(torch, lambda: batcher(gen, wave, labels))
    step_ms = cuda_ms_median(torch, lambda: step(state, x, y))
    activity = {"batcher": device_activity(torch, lambda: batcher(gen, wave, labels)),
                "train_step": device_activity(torch, lambda: step(state, x, y))}
    return {"batch": int(wave.shape[0]), "batcher_ms": round(batcher_ms, 4),
            "train_step_ms": round(step_ms, 4), "device_activity": activity,
            "device_chunks_per_s": round(wave.shape[0] * 1000.0 / (batcher_ms + step_ms), 1)}


def train_phase(torch, np, flagship, tmp: Path) -> tuple[dict, tuple]:
    """The port's `train` entry point at the flagship's full width on a
    seeded WAV folder (tmp/data, the run in tmp/run, both kept for the
    evaluate and train-options phases): two epochs of TRAIN_STEPS, then
    --resume for a third; the run directory, losses and launches; one step
    card vs CPU; the trained run served by `serve`; step and batcher times.
    Returns the linear kernel's launches by run and the first int16 batch
    (FIFO) the checks used."""
    import csv

    from birdnet_stm32_tpu_torch.cli.train import build_loaders
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from tests import make_torch_convert_fixtures as CF

    linear = frontend_kernel.kernel_name("linear", "none")
    launches = {}
    data, run_dir = tmp / "data", tmp / "run"
    t0 = time.perf_counter()
    CF.write_train_folder(data, flagship.class_names)
    write_s = time.perf_counter() - t0
    train_loader, val_loader, class_names, _ = build_loaders(loader_args(data, 4),
                                                             ship="int16")
    if class_names != sorted(flagship.class_names):
        fail("train folder: the classes found are not the flagship's")
    val_batches = -(-len(val_loader.paths) // TRAIN_BATCH)
    for run, epochs, extra in (("train", 2, []), ("resume", 3, ["--resume"])):
        seen = {}
        frontend_kernel.launches.clear()
        t0 = time.perf_counter()
        run_train(torch, train_args(data, run_dir, epochs) + extra, seen)
        wall = time.perf_counter() - t0
        counts = dict(frontend_kernel.launches)
        new_epochs = 2 if run == "train" else 1
        want = new_epochs * (TRAIN_STEPS + val_batches)
        if counts != {linear: want}:
            fail(f"train ({run}): kernel launches {counts}, want {{{linear!r}: {want}}} "
                 "(one per train step and per validation batch)")
        if seen.get("params") != {"cuda"}:
            fail(f"train ({run}): parameters on {seen.get('params')}")
        if {d for d, _ in seen.get("batch", ())} != {"cuda"} or (
                "cuda", "torch.int16") not in seen["batch"]:
            fail(f"train ({run}): batches {seen.get('batch')}")
        launches[run] = want
        print(json.dumps({"train_run": run, "wall_s": round(wall, 3),
                          "linear_launches": counts[linear]}))
    rows = list(csv.DictReader(open(run_dir / "history.csv")))
    state = torch.load(run_dir / "last/train_state.pt", map_location="cpu",
                       weights_only=True)
    losses = [float(r["loss"]) for r in rows]
    print(json.dumps({"train_history": [
        {k: float(v) for k, v in r.items()} for r in rows],
        "write_folder_s": round(write_s, 3), "card": card()}))
    for name in ("best/state_dict.pt", "last/train_state.pt", "model_config.json",
                 "labels.txt", "train_state.json", "history.csv"):
        if not (run_dir / name).exists():
            fail(f"train: run directory lacks {name}")
    if len(rows) != 3:
        fail(f"train: history.csv has {len(rows)} rows, want 3")
    if not all(np.isfinite(float(v)) for r in rows for k, v in r.items()
               if k in ("loss", "val_loss")):
        fail(f"train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the last epoch's loss {losses[-1]} is not below the first's {losses[0]}")
    if state["step"] != 3 * TRAIN_STEPS or state["opt_state"]["count"] != 3 * TRAIN_STEPS:
        fail(f"train: resumed step {state['step']}, want {3 * TRAIN_STEPS}")
    for r in rows:
        n = TRAIN_BATCH * TRAIN_STEPS
        print(json.dumps({"train_epoch": int(float(r["epoch"])),
                          "data_wait_s": float(r["data_wait_s"]),
                          "dispatch_s": float(r["dispatch_s"]),
                          "val_s": float(r["val_s"]),
                          "host_loop_chunks_per_s": round(
                              n / (float(r["data_wait_s"]) + float(r["dispatch_s"])), 1),
                          "epoch_chunks_per_s": round(n / float(r["seconds"]), 1)}))

    # Serve the trained run directory with the port's serve verb.
    serve_dir = tmp / "serve"
    serve_dir.mkdir()
    for name in class_names[:2]:
        (serve_dir / f"{name}.wav").write_bytes((data / name / "0.wav").read_bytes())
    frontend_kernel.launches.clear()
    run_verb("serve", ["--model_path", str(run_dir), "--audio_dir", str(serve_dir), "--once",
               "--results_file", str(tmp / "served.tsv")])
    launches["serve"] = frontend_kernel.launches.get(linear, 0)
    served = tsv_rows(np, tmp / "served.tsv")
    if len(served) != 2 or not all(
            v.shape == (100,) and np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all()
            for _, v in served.values()):
        fail(f"serve of the trained run: {served}")
    if launches["serve"] < 1 or set(frontend_kernel.launches) != {linear}:
        fail(f"serve of the trained run: launches {dict(frontend_kernel.launches)}")

    # One int16 batch for the checks below: the first TRAIN_BATCH chunks
    # in file order (FIFO, the same in every run), read in threads with
    # no pool to spawn and a reservoir of two batches.
    wave, labels = next(iter(dataclasses.replace(
        train_loader, executor="thread", shuffle=False, infinite=False,
        reservoir_size=2 * TRAIN_BATCH)))
    if wave.dtype != np.int16 or wave.shape[0] != TRAIN_BATCH:
        fail(f"the int16 feed shipped {wave.dtype} {wave.shape}")
    launches["librosa_pwl"] = features_train_check(torch, np, flagship, wave, labels,
                                                   tmp)
    train_step_check(torch, flagship, wave, labels)
    timing = train_timing(torch, flagship, wave, labels)
    print(json.dumps({"train_timing": timing, "card": card()}))
    return launches, (wave, labels)


# The evaluate phase's subset of the train phase's folder: the first file
# of each of the first EVAL_CLASSES classes (2-3 chunks each), evaluated
# with --max_files 1 on the card and, for the comparison, on the CPU.
EVAL_CLASSES = 100
EVAL_FLAGS = ["--batch_size", str(B), "--max_files", "1", "--optimize_thresholds",
              "--bootstrap_ci", "--n_bootstrap", "50", "--det_curve", "--benchmark_latency",
              "--profile_memory", "--save_csv", "--save_benchmark_json"]
EVAL_REPORTS = ("predictions.csv", "species_report.csv", "benchmark.json", "thresholds.json")
# Card against CPU on the same command, per-file pooled scores: float32
# within 1e-4 (the slice phase's gate); bf16 and INT8 at cosine >= 0.999
# per file (an INT8 entry code fed by the kernel may differ by one from the
# plain version's, ROADMAP Queue 3 item 2).
EVAL_F32_ATOL = 1e-4
EVAL_MIN_COSINE = 0.999
# Card against CPU, |difference| of roc-auc, cmAP and mAP. First reading
# (NVIDIA H100 80GB HBM3, 700 W): INT8 2.1e-5 / 2.4e-5 / 9.2e-6, bf16
# 1.5e-6 / 8.4e-6 / 6.6e-6, float32 0; the gate stands 40x above the worst.
# A class's single positive moving from rank r to r + 1 moves cmAP by
# 1 / (100 r (r + 1)): the gate admits one such swap at rank 3 or deeper.
EVAL_METRIC_ATOL = 1e-3
# The benchmark modes over the serve phase's six files.
BENCH_MODES = {"serial": [], "pipeline": ["--pipeline", "4"], "int16": ["--int16_io"],
               "ulaw": ["--ulaw_io"], "device_resample": ["--device_resample"],
               "trace": ["--trace_dir"]}
PIPELINE_ATOL = 1e-5


def run_evaluate(args: list[str]) -> dict:
    """`evaluate` in this process, with evaluation.metrics.evaluate wrapped
    to keep what it returns (metrics, per-file records, pooled scores) and
    its wall seconds."""
    from birdnet_stm32_tpu_torch.evaluation import metrics

    real, seen = metrics.evaluate, {}

    def spy(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        seen.update(wall_s=time.perf_counter() - t0, metrics=out[0], per_file=out[1],
                    y_scores=out[3])
        return out

    metrics.evaluate = spy
    try:
        seen["stdout"] = run_verb("evaluate", args)
    finally:
        metrics.evaluate = real
    return seen


def evaluate_checks(torch, np, tmp: Path, launches: dict) -> None:
    """(a) of the evaluate phase: the INT8 bundle (plain, --int16_io, and
    twice through --cache_dir) and the train phase's run (float32, --bf16)
    on the card, then the INT8, float32 and bf16 commands on the CPU."""
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    linear = frontend_kernel.kernel_name("linear", "none")
    subset = tmp / "eval"
    for folder in sorted(d for d in (tmp / "data").iterdir() if d.name != "noise")[:EVAL_CLASSES]:
        (subset / folder.name).mkdir(parents=True)
        (subset / folder.name / "0.wav").write_bytes((folder / "0.wav").read_bytes())
    models = {"int8": [str(FLAGSHIP_TFLITE)], "float32": [str(tmp / "run")],
              "bf16": [str(tmp / "run"), "--bf16"]}
    cache = tmp / "eval_cache"
    legs = {"int8": (models["int8"], "cuda"),
            "int8 --int16_io": (models["int8"] + ["--int16_io"], "cuda"),
            "int8 --cache_dir (miss)": (models["int8"] + ["--cache_dir", str(cache)], "cuda"),
            "int8 --cache_dir (hit)": (models["int8"] + ["--cache_dir", str(cache)], "cuda"),
            "float32": (models["float32"], "cuda"), "bf16": (models["bf16"], "cuda"),
            "int8 cpu": (models["int8"], "cpu"), "float32 cpu": (models["float32"], "cpu"),
            "bf16 cpu": (models["bf16"], "cpu")}
    runs = {}
    for i, (leg, (model, device)) in enumerate(legs.items()):
        out_dir = tmp / "eval_out" / str(i)
        frontend_kernel.launches.clear()
        r = run_evaluate(["--model_path", *model, "--data_path_test", str(subset),
                          "--output_dir", str(out_dir), "--device", device, *EVAL_FLAGS])
        r["launches"] = dict(frontend_kernel.launches)
        runs[leg] = r
        m, y = r["metrics"], r["y_scores"]
        chunks = m["total_chunks"]
        print(json.dumps({"evaluate_leg": leg, "files": len(r["per_file"]), "chunks": chunks,
                          "wall_s": r["wall_s"], "chunks_per_s": chunks / r["wall_s"],
                          **{k: m.get(k) for k in ("roc-auc", "cmAP", "mAP", "precision",
                                                   "recall", "f1", "latency_mean_ms",
                                                   "blocking_read_floor_ms", "peak_rss_mb")},
                          "kernel_launches": r["launches"]}))
        if len(r["per_file"]) != EVAL_CLASSES or y.shape != (EVAL_CLASSES, 100) or \
                not np.isfinite(y).all():
            fail(f"evaluate {leg}: {len(r['per_file'])} files, scores {y.shape}")
        values = [m[k] for k in ("roc-auc", "cmAP", "mAP", "precision", "recall", "f1")]
        if not all(np.isfinite(v) for v in values + list(m["ap_per_class"])):
            fail(f"evaluate {leg}: a metric is not finite: {values}")
        for name in EVAL_REPORTS:
            if not (out_dir / name).exists():
                fail(f"evaluate {leg}: no {name}")
        if device == "cuda":
            # One launch per device batch, the --benchmark_latency warm-up
            # batch included; no other frontend kernel.
            want = -(-chunks // B) + 1
            if r["launches"] != {linear: want}:
                fail(f"evaluate {leg}: launches {r['launches']}, want {{{linear!r}: {want}}}")
            launches[f"evaluate {leg}"] = want
    int8 = runs["int8"]["y_scores"]
    for leg in ("int8 --int16_io", "int8 --cache_dir (miss)", "int8 --cache_dir (hit)"):
        if not np.array_equal(runs[leg]["y_scores"], int8):
            fail(f"evaluate {leg}: pooled scores differ from the plain INT8 run's")
    if len(list(cache.glob("*.npy"))) != EVAL_CLASSES:
        fail(f"evaluate --cache_dir: {len(list(cache.glob('*.npy')))} cache entries")
    report = {}
    for leg in ("int8", "float32", "bf16"):
        card_run, cpu_run = runs[leg], runs[f"{leg} cpu"]
        if [f["file"] for f in card_run["per_file"]] != [f["file"] for f in cpu_run["per_file"]]:
            fail(f"evaluate {leg}: the card and the CPU evaluated other files")
        a, b = card_run["y_scores"].astype(np.float64), cpu_run["y_scores"].astype(np.float64)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        report[leg] = {"max_abs": float(np.abs(a - b).max()), "min_cosine": float(cos.min()),
                       **{f"{k}_diff": abs(card_run["metrics"][k] - cpu_run["metrics"][k])
                          for k in ("roc-auc", "cmAP", "mAP")}}
    print(json.dumps({"evaluate_chunks_per_s": {
        leg: r["metrics"]["total_chunks"] / r["wall_s"] for leg, r in runs.items()},
        "evaluate_card_vs_cpu": report, "card": card()}))
    for leg, r in report.items():
        if leg == "float32" and not r["max_abs"] <= EVAL_F32_ATOL:
            fail(f"evaluate {leg}: card vs CPU pooled scores {r['max_abs']:.3e} > {EVAL_F32_ATOL}")
        if not r["min_cosine"] >= EVAL_MIN_COSINE:
            fail(f"evaluate {leg}: card vs CPU cosine {r['min_cosine']} < {EVAL_MIN_COSINE}")
        for k in ("roc-auc", "cmAP", "mAP"):
            if not r[f"{k}_diff"] <= EVAL_METRIC_ATOL:
                fail(f"evaluate {leg}: card vs CPU {k} differs by {r[k + '_diff']:.3e}")


def run_benchmark_verb(args: list[str]) -> tuple[str, dict]:
    """`benchmark` in this process: its standard output and the summary its
    driver returns (unrounded wall seconds, real-time factor, chunks/s)."""
    from birdnet_stm32_tpu_torch.cli import benchmark

    seen = {}

    def spying(driver):
        def spy(*a, **k):
            result = driver(*a, **k)
            seen.update(result)
            return result
        return spy

    real = benchmark.run_benchmark, benchmark.run_benchmark_pipelined
    benchmark.run_benchmark, benchmark.run_benchmark_pipelined = map(spying, real)
    try:
        out = run_verb("benchmark", args)
    finally:
        benchmark.run_benchmark, benchmark.run_benchmark_pipelined = real
    return out, {k: seen[k] for k in ("files", "chunks", "wall_s", "rtf", "chunks_per_sec")}


def benchmark_checks(np, tmp: Path, launches: dict) -> Path:
    """(b) and (c) of the evaluate phase: `benchmark` over the serve phase's
    six files in BENCH_MODES, then `board-test` from a TOML deploy config.
    Returns the files' directory."""
    import csv

    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.serving import decode_for_classify
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    linear = frontend_kernel.kernel_name("linear", "none")
    audio = tmp / "bench"
    audio.mkdir()
    write_serve_files(np, audio)
    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    chunks = {resample: [len(decode_for_classify(audio / f[0], cfg, device_resample=resample)[0])
                         for f in SERVE_FILES] for resample in (False, True)}
    rates = len({f[1] for f in SERVE_FILES} | {cfg.sample_rate})
    rows, timing = {}, {}
    for mode, extra in BENCH_MODES.items():
        if mode == "trace":
            extra = extra + [str(tmp / "trace")]
        csv_path = tmp / f"bench_{mode}.csv"
        frontend_kernel.launches.clear()
        out, timing[mode] = run_benchmark_verb(["--model_path", str(FLAGSHIP_TFLITE),
                                                "--audio_dir", str(audio), "--csv",
                                                str(csv_path), *extra])
        counts = dict(frontend_kernel.launches)
        n = chunks[mode == "device_resample"]
        # Each batch once, plus one warm-up batch per source rate; the
        # pipelined driver packs every file's chunks into shared batches.
        want = (-(-sum(n) // B) + 1 if mode == "pipeline"
                else sum(-(-k // B) for k in n) + (rates if mode == "device_resample" else 1))
        if counts != {linear: want}:
            fail(f"benchmark {mode}: launches {counts}, want {{{linear!r}: {want}}}")
        launches[f"benchmark {mode}"] = want
        if out.count("[BENCH] read:") != len(SERVE_FILES) or "=== DONE ===" not in out:
            fail(f"benchmark {mode}: {out.count('[BENCH] read:')} [BENCH] lines:\n{out[-1500:]}")
        rows[mode] = list(csv.DictReader(open(csv_path)))
    serial, piped = rows["serial"], rows["pipeline"]
    top1_equal = [a["top1"] == b["top1"] for a, b in zip(serial, piped)]
    score_diff = max(abs(float(a["score"]) - float(b["score"])) for a, b in zip(serial, piped))
    trace = tmp / "trace" / "benchmark_trace.json"
    trace_names_kernel = trace.exists() and "frontend_linear_kernel" in trace.read_text()
    print(json.dumps({"benchmark_done": timing, "pipelined_vs_serial": {
        "top1_equal": all(top1_equal), "max_score_diff": score_diff},
        "trace_bytes": trace.stat().st_size if trace.exists() else None, "card": card()}))
    if [a["file"] for a in serial] != [b["file"] for b in piped] or not all(top1_equal) \
            or not score_diff <= PIPELINE_ATOL:
        fail(f"benchmark --pipeline differs from serial: top-1 {top1_equal}, score {score_diff}")
    if not trace_names_kernel:
        fail(f"benchmark --trace_dir: {trace} is missing or names no frontend_linear_kernel")

    toml = tmp / "deploy.toml"
    toml.write_text(f'[serving]\nmodel_path = "{FLAGSHIP_TFLITE}"\naudio_dir = "{audio}"\n'
                    f"batch_size = {B}\n")
    frontend_kernel.launches.clear()
    run_verb("board-test", ["--config", str(toml), "--save_results", str(tmp / "board.csv")])
    want = launches["benchmark serial"]
    if dict(frontend_kernel.launches) != {linear: want}:
        fail(f"board-test: launches {dict(frontend_kernel.launches)}, want {want}")
    launches["board-test"] = want
    board = list(csv.reader(open(tmp / "board.csv")))
    if board[0] != ["file", "top_label", "top_score"] or len(board) != len(SERVE_FILES) + 1 \
            or not all(r[1] in cfg.class_names and 0 <= float(r[2]) <= 1 for r in board[1:]):
        fail(f"board-test --save_results: {board}")
    return audio


def evaluate_phase(torch, np, flagship, tmp: Path) -> dict:
    """The `evaluate`, `benchmark`, `board-test` and `profile` verbs on
    CUDA, (a)-(e) of the module docstring; returns the linear kernel's
    launches by run."""
    import re

    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

    launches = {}
    evaluate_checks(torch, np, tmp, launches)
    benchmark_checks(np, tmp, launches)
    out = run_verb("profile", ["--config_path",
                               str(FLAGSHIP_TFLITE.parent / "model_config.json")])
    params = int(re.search(r"Total params: ([\d,]+)", out).group(1).replace(",", ""))
    want = sum(p.numel() for p in build_dscnn(flagship, device="cuda").parameters())
    print(json.dumps({"profile_params": params, "dscnn_params": want}))
    if params != want:
        fail(f"profile: {params} parameters, the port's DS-CNN has {want}")
    return launches


# The train-options phase: the QAT, probe, tuning and distillation runs
# train OPT_STEPS steps per epoch, and read their WAVs in-process
# (OPT_WORKERS: the train phase holds the spawn pool; a pool's start-up
# would be most of these short runs), the LR finder's 100-step sweep with
# the default pool. The mixed-precision step's loss against the float32
# step's from the trained run's state on one batch: a bf16 forward rounds
# every activation to 8 bits of mantissa. Readings on an H100 80GB HBM3 at
# 700 W, three runs: 9.7e-5 to 3.9e-4 relative; the gate stands 13-50x
# above them. The QAT step card vs CPU keeps the train phase's gates
# (readings: loss 6.3e-8, gradient norm <= 9.5e-6, worst tensor <= 1.4e-3,
# whole update <= 5.0e-4).
OPT_STEPS = 4
OPT_WORKERS = "0"
MIXED_LOSS_RTOL = 5e-3
TUNE_TRIALS = 2


def check_launches(name: str, seen: dict, steps: int) -> int:
    """The linear kernel launched once per train step and per validation
    batch and nothing else launched; returns its launches."""
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    linear = frontend_kernel.kernel_name("linear", "none")
    counts = dict(frontend_kernel.launches)
    want = seen.get("steps", 0) + seen.get("val", 0)
    if seen.get("steps") != steps or counts != {linear: want}:
        fail(f"{name}: {seen.get('steps')} steps (want {steps}), {seen.get('val')} validation "
             f"batches, launches {counts} (want {{{linear!r}: {want}}})")
    return want


def best_weights(run: Path) -> dict:
    """A run directory's best/ state_dict, on the CPU."""
    import torch

    return torch.load(run / "best/state_dict.pt", map_location="cpu", weights_only=True)


def mixed_precision_checks(torch, np, tmp: Path, wave, labels) -> int:
    """(a): `train --mixed_precision`, 1 epoch of TRAIN_STEPS, and one
    mixed step's loss against the float32 step's from the same state."""
    import copy

    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
    from birdnet_stm32_tpu_torch.training.checkpoint import load_checkpoint
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer

    seen = {}
    frontend_kernel.launches.clear()
    run_train(torch, train_args(tmp / "data", tmp / "run_mixed", 1, workers=OPT_WORKERS)
              + ["--mixed_precision"], seen)
    n = check_launches("train --mixed_precision", seen, TRAIN_STEPS)
    f32, b16 = "torch.float32", "torch.bfloat16"
    losses = [float(v) for v in seen["step_losses"]]
    if seen["params"] != {"cuda"} or seen["param_dtypes"] != {f32}:
        fail(f"mixed precision: masters {seen['params']} {seen['param_dtypes']}")
    if ("cuda", b16) not in seen["batch"] or seen["stem"] != {(b16, b16), (f32, f32)}:
        fail(f"mixed precision: batches {seen['batch']}, stem conv (input, weight) "
             f"{seen['stem']} (want bf16 in training, float32 in validation)")
    half = len(losses) // 2
    if not (np.isfinite(losses).all() and np.mean(losses[half:]) < np.mean(losses[:half])):
        fail(f"mixed precision: step losses {losses} are not finite and falling")
    # One step from the trained run's state, mixed against float32.
    model, _, cfg = load_checkpoint(tmp / "run", class_activation="none", device="cuda")
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    batcher = make_train_batcher(cfg, spec_augment=False, mixup_probability=0.0,
                                 input_dtype="int16")
    x, y = batcher(None, torch.as_tensor(wave).cuda(), torch.as_tensor(labels).cuda())
    step_loss = {}
    for dt in (None, torch.bfloat16):
        m = copy.deepcopy(model)
        tx = build_optimizer("adam", 1e-3, gradient_clip_norm=1.0)
        _, metrics = make_train_step(m, tx, make_loss_fn(multilabel=True), compute_dtype=dt)(
            TrainState.create(m, tx), x if dt is None else x.to(dt), y)
        step_loss[str(dt)] = float(metrics["loss"])
    rel = abs(step_loss[str(torch.bfloat16)] - step_loss["None"]) / step_loss["None"]
    print(json.dumps({"mixed_precision": {"launches": n, "step_losses": losses,
                                          "step_loss_bf16_vs_fp32_rel": rel,
                                          "step_loss": step_loss}}))
    if not rel <= MIXED_LOSS_RTOL:
        fail(f"mixed precision: the bf16 step's loss is {rel:.3e} from the float32 "
             f"step's (> {MIXED_LOSS_RTOL:.0e})")
    return n


def qat_checks(torch, np, tmp: Path, wave, labels) -> dict:
    """(b): `train --qat`, then `--qat --qat_act`, each 2 epochs of
    OPT_STEPS on the trained run; `serve` of <run>_qat; fake-quant card vs
    CPU; one QAT step card vs CPU."""
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.quant.fake_quant import fake_quantize_act, quantize_params

    launches = {}
    base, qat = best_weights(tmp / "run"), tmp / "run_qat"
    for name, extra in (("qat", ["--qat"]), ("qat_act", ["--qat", "--qat_act"])):
        seen = {}
        frontend_kernel.launches.clear()
        run_train(torch, train_args(tmp / "data", tmp / "run", 2, OPT_STEPS, OPT_WORKERS) + extra,
                  seen)
        launches[name] = check_launches(f"train {' '.join(extra)}", seen, 2 * OPT_STEPS)
        tuned = best_weights(qat)
        bn = [k for k in base if "_bn." in k]
        if not all(torch.equal(tuned[k], base[k]) for k in bn):
            fail(f"{name}: a BN tensor moved")
        kernels = [k for k in base if k.endswith(".weight") and base[k].ndim >= 2]
        still = [k for k in kernels if torch.equal(tuned[k], base[k])]
        if still:
            fail(f"{name}: kernels did not move: {still[:5]}")
        losses = [h["loss"] for hs in seen["histories"] for h in hs]
        if not np.isfinite(losses).all() or seen["param_dtypes"] != {"torch.float32"}:
            fail(f"{name}: losses {losses}, parameters {seen['param_dtypes']}")
        print(json.dumps({name: {"launches": launches[name], "epoch_losses": losses,
                                 "bn_tensors_equal": len(bn), "kernels_moved": len(kernels)}}))
    frontend_kernel.launches.clear()
    run_verb("serve", ["--model_path", str(qat), "--audio_dir", str(tmp / "serve"), "--once",
                       "--results_file", str(tmp / "served_qat.tsv")])
    launches["qat_serve"] = sum(frontend_kernel.launches.values())
    if set(frontend_kernel.launches) != {frontend_kernel.kernel_name("linear", "none")}:
        fail(f"serve of the QAT run: launches {dict(frontend_kernel.launches)}")
    served = tsv_rows(np, tmp / "served_qat.tsv")
    if len(served) != 2 or not all(v.shape == (100,) and np.isfinite(v).all()
                                   for _, v in served.values()):
        fail(f"serve of the QAT run: {served}")
    # Fake-quant on the card, bit for bit the CPU's.
    gpu = {k: v.cuda() for k, v in base.items()}
    mismatches = 0
    for per_channel in (True, False):
        qc, qg = (quantize_params(t, per_channel=per_channel, ste=False) for t in (base, gpu))
        mismatches += sum(not torch.equal(qg[k].cpu(), qc[k]) for k in qc)
    x = torch.as_tensor(wave[:8, :-1].astype(np.float32) / 32767.0)
    for t in (x, x.abs() * 6.0):
        mismatches += not torch.equal(fake_quantize_act(t.cuda()).cpu(), fake_quantize_act(t))
    print(json.dumps({"fake_quant_card_vs_cpu_mismatched_tensors": mismatches,
                      "quantizable_tensors": sum(k.endswith(".weight") and v.ndim >= 2
                                                 for k, v in base.items())}))
    if mismatches:
        fail(f"fake-quant: {mismatches} tensors differ between the card and the CPU")
    train_step_check(torch, tmp_cfg(tmp), wave, labels, qat=True, state_dict=base)
    # The features kernel under the QAT step with activation fake-quant.
    launches["qat_librosa_pwl"] = features_train_check(
        torch, np, tmp_cfg(tmp), wave, labels, tmp, key="qat_librosa_pwl", qat=True,
        qat_act=True)
    return launches


def tmp_cfg(tmp: Path):
    from birdnet_stm32_tpu_torch.config import ModelConfig

    return ModelConfig.load(tmp / "run" / "model_config.json")


def probe_and_lr_checks(torch, np, tmp: Path) -> dict:
    """(c) `--linear_probe` (1 epoch of OPT_STEPS) and (d) `--find_lr`
    (the default 100-step sweep), each with its batches counted."""
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.training import linear_probe, lr_finder

    launches, seen = {}, {}
    real_probe, real_lr = linear_probe.run_linear_probe, lr_finder.run_lr_finder

    def probe(sd, cfg, classes, train_batches, val_batches, run_dir, **kw):
        return real_probe(sd, cfg, classes, counted(seen, "steps", train_batches),
                          lambda: counted(seen, "val", val_batches()), run_dir, **kw)

    def sweep(model, batches, loss_fn, **kw):
        seen["sweep"] = real_lr(model, counted(seen, "steps", batches), loss_fn, **kw)
        return seen["sweep"]

    linear_probe.run_linear_probe, lr_finder.run_lr_finder = probe, sweep
    try:
        frontend_kernel.launches.clear()
        run_verb("train", [*train_args(tmp / "data", tmp / "run", 1, OPT_STEPS, OPT_WORKERS),
                           "--linear_probe"])
        launches["probe"] = check_launches("train --linear_probe", seen, OPT_STEPS)
        base, probed = best_weights(tmp / "run"), best_weights(tmp / "run_probe")
        moved = [k for k in base if not k.startswith("pred.") and not torch.equal(
            base[k].reshape(-1).view(torch.uint8), probed[k].reshape(-1).view(torch.uint8))]
        if moved or torch.equal(base["pred.weight"], probed["pred.weight"]):
            fail(f"linear probe: backbone tensors moved {moved[:5]}, or the head did not")
        seen.clear()
        frontend_kernel.launches.clear()
        out = run_verb("train", [*train_args(tmp / "data", tmp / "run_lr", 1), "--find_lr"])
    finally:
        linear_probe.run_linear_probe, lr_finder.run_lr_finder = real_probe, real_lr
    sweep_out = seen["sweep"]
    lr, lrs = sweep_out["suggested_lr"], sweep_out["lrs"]
    # One batch and one launch per learning rate of the sweep.
    launches["find_lr"] = check_launches("train --find_lr", dict(seen, val=0), len(lrs))
    print(json.dumps({"linear_probe": {"launches": launches["probe"],
                                       "backbone_tensors": len(base) - 2},
                      "find_lr": {"launches": launches["find_lr"], "steps": len(lrs),
                                  "suggested_lr": lr, "printed": out.strip().splitlines()[-1]}}))
    if not (np.isfinite(lr) and min(lrs) <= lr <= max(lrs)):
        fail(f"find_lr: suggestion {lr} outside the sweep {min(lrs)}..{max(lrs)}")
    return launches


def tune_and_distill_checks(torch, np, tmp: Path) -> dict:
    """(e) `--tune 2`: two trials of 2 epochs x OPT_STEPS; (f)
    run_distillation with the trained run as the teacher, 1 epoch x
    OPT_STEPS on the float32 feed."""
    from birdnet_stm32_tpu_torch.cli.train import build_loaders
    from birdnet_stm32_tpu_torch.device import full_fp32
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.training.checkpoint import load_checkpoint
    from birdnet_stm32_tpu_torch.training.distillation import run_distillation

    launches, seen = {}, {}
    frontend_kernel.launches.clear()
    run_train(torch, train_args(tmp / "data", tmp / "tune", 2, OPT_STEPS, OPT_WORKERS)
              + ["--tune", str(TUNE_TRIALS)], seen)
    launches["tune"] = check_launches("train --tune", seen, TUNE_TRIALS * 2 * OPT_STEPS)
    best = json.loads((tmp / "tune/best_params.json").read_text())
    trials = [json.loads((tmp / f"tune/trial_{i}/model_config.json").read_text())
              for i in range(TUNE_TRIALS)]
    if best["trial"] not in range(TUNE_TRIALS) or len(seen["histories"]) != TUNE_TRIALS:
        fail(f"tune: best_params {best}, {len(seen['histories'])} trials")
    print(json.dumps({"tune": {"launches": launches["tune"], "best": best,
                               "trial_blocks": [{k: c[k] for k in (
                                   "alpha", "depth_multiplier", "use_se",
                                   "use_inverted_residual", "use_attention_pooling")}
                                   for c in trials]}}))

    teacher, _, cfg = load_checkpoint(tmp / "run", device="cuda")

    def teacher_fn(x):
        with full_fp32():
            return teacher(x)

    student = init_model(build_dscnn(cfg, class_activation="none", device="cuda"), seed=7)
    train_loader, val_loader, _, _ = build_loaders(loader_args(tmp / "data", int(OPT_WORKERS)))
    seen = {}
    batches = iter(train_loader)
    frontend_kernel.launches.clear()
    try:
        _, history = run_distillation(
            student, cfg, teacher_fn, counted(seen, "steps", batches),
            lambda: counted(seen, "val", iter(val_loader)), tmp / "distill",
            epochs=1, steps_per_epoch=OPT_STEPS, multilabel=True, device="cuda")
    finally:
        batches.close()
    launches["distill"] = check_launches("run_distillation", seen, OPT_STEPS)
    print(json.dumps({"distillation": {"launches": launches["distill"], "history": history}}))
    if not (np.isfinite(history[0]["loss"]) and np.isfinite(history[0]["val_loss"])
            and (tmp / "distill/best/state_dict.pt").exists()):
        fail(f"distillation: history {history}")
    return launches


def options_timing(torch, tmp: Path, wave, labels) -> dict:
    """(g): the float32, mixed-precision and QAT (activation fake-quant off
    and on) adam steps on one batch of TRAIN_BATCH from the trained run's
    state, each the median of seven CUDA-event timings after two warm-up
    calls, with the CUDA launches and device-busy ms of one call."""
    import copy

    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
    from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
    from birdnet_stm32_tpu_torch.quant.qat import make_qat_train_step
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer
    from birdnet_stm32_tpu_torch.utils.prng import generator

    cfg = tmp_cfg(tmp)
    model = build_dscnn(cfg, class_activation="none", device="cuda")
    model.load_state_dict(best_weights(tmp / "run"))
    wave, labels = torch.as_tensor(wave).cuda(), torch.as_tensor(labels).cuda()
    x, y = make_train_batcher(cfg, input_dtype="int16")(generator(0, "cuda"), wave, labels)
    steps = {
        "fp32": (lambda m, tx, lf: make_train_step(m, tx, lf), x),
        "mixed_bf16": (lambda m, tx, lf: make_train_step(m, tx, lf,
                                                        compute_dtype=torch.bfloat16),
                       x.to(torch.bfloat16)),
        "qat": (lambda m, tx, lf: make_qat_train_step(m, tx, lf), x),
        "qat_act": (lambda m, tx, lf: make_qat_train_step(m, tx, lf, act_fq=True), x),
    }
    out = {}
    for name, (make, xx) in steps.items():
        m = copy.deepcopy(model)
        tx = build_optimizer("adam", 1e-3, gradient_clip_norm=1.0)
        step = make(m, tx, make_loss_fn(multilabel=True))
        st = TrainState.create(m, tx)
        out[name] = {"ms": round(cuda_ms_median(torch, lambda: step(st, xx, y)), 4),
                     **device_activity(torch, lambda: step(st, xx, y))}
    return out


def train_options_phase(torch, np, tmp: Path, wave, labels) -> dict:
    """The `train` options at the flagship's full width on the train
    phase's folder and run (tmp/data, tmp/run), (a)-(g) of the module
    docstring; returns the linear kernel's launches by run."""
    seconds, launches = {}, {}
    for name, fn, args in (("mixed", mixed_precision_checks, (wave, labels)),
                           ("qat", qat_checks, (wave, labels)),
                           ("probe_find_lr", probe_and_lr_checks, ()),
                           ("tune_distill", tune_and_distill_checks, ())):
        t0 = time.perf_counter()
        out = fn(torch, np, tmp, *args)
        launches.update(out if isinstance(out, dict) else {name: out})
        seconds[name] = round(time.perf_counter() - t0, 3)
    print(json.dumps({"train_options_timing": options_timing(torch, tmp, wave, labels),
                      "batch": TRAIN_BATCH, "card": card(), "seconds": seconds}))
    return launches


# The convert phase. The calibration features are the composition
# (ops/frontend.py::inputs_for_config) on each device: float32 DFT matmuls
# summed in another order, then min-max normalized to [0, 1]. The first
# run on an H100 80GB HBM3 at 700 W read 1.2e-7 (one ulp below 1.0) on the
# 100 flagship features; the gate stands 8x above it.
CONVERT_FEATURE_TOL = 1e-6
# The float runner's softmax scores card vs CPU, relative to each row's
# spread (max - min; the scores spread 0.03 per row). Read: 2.4e-6.
CONVERT_FLOAT_RTOL = 1e-5
CONVERT_STATS_TOL = 1e-4
CONVERT_REPORT_TOL = 1e-3
# get_spectrogram_from_audio card vs CPU: the composition's gate against
# JAX on the CPU (tests/test_torch_api_tail.py), 1e-5.
SPECTROGRAM_API_TOL = 1e-5


class Recorded:
    """A runner that keeps what its predict() returned."""

    def __init__(self, runner):
        self.runner, self.outputs = runner, []

    def predict(self, x):
        y = self.runner.predict(x)
        self.outputs.append(y)
        return y


def convert_verb_check(run: Path, data: Path, out: Path) -> dict:
    """(a): the convert verb without TensorFlow exits 2 before loading or
    calibrating; with it, the real conversion."""
    import contextlib
    import importlib.util
    import io
    from unittest import mock

    from birdnet_stm32_tpu_torch.__main__ import main as port_main
    from birdnet_stm32_tpu_torch.conversion import pipeline
    from birdnet_stm32_tpu_torch.training import checkpoint

    args = ["--model_path", str(run), "--data_path", str(data),
            "--output_path", str(out / "model_quantized.tflite"), "--no_npz"]
    if importlib.util.find_spec("tensorflow") is not None:
        print(json.dumps({"convert_verb": "TensorFlow imports here: the real conversion runs"}))
        run_verb("convert", args)
        return {"verb": "converted",
                "tflite_bytes": (out / "model_quantized.tflite").stat().st_size}

    def forbidden(*a, **k):
        raise AssertionError("convert loaded or calibrated without TensorFlow")

    err = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(checkpoint, "load_checkpoint", forbidden), \
            mock.patch.object(pipeline, "representative_inputs", forbidden), \
            mock.patch.object(pipeline, "convert_model", forbidden), \
            contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = port_main(["convert", *args])
    ms = (time.perf_counter() - t0) * 1000
    if rc != 2 or "TensorFlow" not in err.getvalue():
        fail(f"convert without TensorFlow: exit {rc}, {err.getvalue()!r}")
    return {"verb": "exit 2 without TensorFlow", "verb_ms": ms}


def convert_phase(torch, np, tmp: Path) -> int:
    """(14) of the module docstring; returns the frontend kernels' launches
    in the phase (calibration is the composition: none)."""
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.quant.validate import validate_runners
    from birdnet_stm32_tpu_torch.training.checkpoint import save_checkpoint, save_train_state
    from tests import make_torch_convert_fixtures as CF
    from tests.torch_fuzz_fixtures import spread_error

    frontend_kernel.launches.clear()
    models = {dev: CF.load_model(dev) for dev in ("cuda", "cpu")}
    cfg = models["cpu"][1]
    run, data = tmp / "convert_run", tmp / "data"
    save_checkpoint(run, models["cpu"][0].state_dict(), cfg)
    save_train_state(run, 1, multilabel=False)  # the softmax head
    report = convert_verb_check(run, data, tmp / "convert_out")

    x, ms = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        x[dev] = CF.calibration_inputs(data, cfg, dev)
        ms[f"calibration_{dev}"] = (time.perf_counter() - t0) * 1000
    if x["cuda"].shape != x["cpu"].shape:
        fail(f"convert: calibration kept {x['cuda'].shape} on the card, {x['cpu'].shape} "
             "on the CPU")
    feat_err = float(np.abs(x["cuda"] - x["cpu"]).max())

    xv = CF.validation_subset(x["cuda"])
    stats, legs = {}, {}
    for dev in ("cuda", "cpu"):
        legs[dev] = (Recorded(TorchRunner(models[dev][0], cfg, device=dev)),
                     Recorded(TFLiteSimRunner(CF.TFLITE, device=dev)))
        t0 = time.perf_counter()
        stats[dev] = validate_runners(*legs[dev], xv)
        ms[f"validation_{dev}"] = (time.perf_counter() - t0) * 1000
    floats, quants = ({dev: np.concatenate(legs[dev][k].outputs) for dev in legs}
                      for k in (0, 1))
    float_err = spread_error(floats["cuda"], floats["cpu"])
    quant_equal = bool(np.array_equal(quants["cuda"], quants["cpu"]))
    stats_gap = max(abs(v - stats["cpu"][k]) for k, v in stats["cuda"].items())
    committed = json.loads(CF.REPORT.read_text())["validation"]["cosine_mean"]
    report_gap = abs(stats["cuda"]["cosine_mean"] - committed)
    spec_err = spectrogram_api_check(np, cfg)
    launches = sum(frontend_kernel.launches.values())
    report.update(ms, n_samples=stats["cuda"]["n_samples"], kept=len(x["cuda"]),
                  spectrogram_api_max_abs_card_vs_cpu=spec_err,
                  feature_max_abs_card_vs_cpu=feat_err, float_spread_err_card_vs_cpu=float_err,
                  int8_bit_equal_card_vs_cpu=quant_equal, stats_max_gap_card_vs_cpu=stats_gap,
                  cosine_mean_card=stats["cuda"]["cosine_mean"], cosine_mean_committed=committed,
                  convert_launches=launches)
    print(json.dumps({"convert_phase": report}))
    if not feat_err <= CONVERT_FEATURE_TOL:
        fail(f"convert: calibration features card vs CPU {feat_err} > {CONVERT_FEATURE_TOL}")
    if not quant_equal:
        fail("convert: the committed export's executor differs card vs CPU")
    if not float_err <= CONVERT_FLOAT_RTOL:
        fail(f"convert: float scores card vs CPU {float_err} of the spread > {CONVERT_FLOAT_RTOL}")
    if not stats_gap <= CONVERT_STATS_TOL:
        fail(f"convert: validation stats card vs CPU differ by {stats_gap}")
    if not report_gap <= CONVERT_REPORT_TOL:
        fail(f"convert: cosine_mean {stats['cuda']['cosine_mean']} vs the committed {committed}")
    if stats["cuda"]["n_samples"] != min(CF.VALIDATE_SAMPLES, len(x["cuda"])):
        fail(f"convert: validated {stats['cuda']['n_samples']} samples")
    for mode, err in spec_err.items():
        if not err <= SPECTROGRAM_API_TOL:
            fail(f"get_spectrogram_from_audio ({mode}) card vs CPU {err} > {SPECTROGRAM_API_TOL}")
    return launches


def spectrogram_api_check(np, cfg) -> dict[str, float]:
    """audio/spectrogram.py::get_spectrogram_from_audio (the composition, no
    kernel) on one seeded flagship chunk, on the card and on the CPU, in
    linear and in mel + pwl mode: the max abs gap per mode."""
    from birdnet_stm32_tpu_torch.audio.spectrogram import get_spectrogram_from_audio

    wave = np.random.default_rng(12).normal(0, 0.1, cfg.chunk_samples).astype(np.float32)
    gaps = {}
    for mode, mag in (("linear", "none"), ("mel", "pwl")):
        out = {dev: get_spectrogram_from_audio(
            wave, sample_rate=cfg.sample_rate, n_fft=cfg.fft_length, mel_bins=cfg.num_mels,
            spec_width=cfg.spec_width, mag_scale=mag, mode=mode, device=dev)
            for dev in ("cuda", "cpu")}
        if out["cuda"].shape != out["cpu"].shape or not np.isfinite(out["cuda"]).all():
            fail(f"get_spectrogram_from_audio ({mode}): {out['cuda'].shape} on the card")
        gaps[f"{mode}_{mag}"] = float(np.abs(out["cuda"] - out["cpu"]).max())
    return gaps


DEPLOY_LAUNCHES = 4  # validate x 2 bundles, and the two bundles' classify


def deploy_phase(torch, np) -> int:
    """(15) of the module docstring; returns the linear kernel's launches."""
    import tempfile
    from unittest import mock

    from birdnet_stm32_tpu_torch.cli import deploy
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from tests import make_torch_convert_fixtures as CF

    committed = json.loads((FLAGSHIP_TFLITE.parent / "manifest.json").read_text())
    validated = []
    validate = deploy.validate_bundle

    def spy(*a, **k):
        validated.append(validate(*a, **k))
        return validated[-1]

    linear = frontend_kernel.kernel_name("linear", "none")
    frontend_kernel.launches.clear()
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(deploy, "validate_bundle", spy):
        out = Path(tmp) / "flagship"
        run_verb("deploy", ["--model_path", str(FLAGSHIP_TFLITE), "--output_dir", str(out)])
        manifest = json.loads((out / "manifest.json").read_text())
        if manifest != committed:
            fail(f"deploy: manifest {manifest} differs from the committed one")
        cfg = ModelConfig.load(out / "model_config.json")
        wave = np.random.default_rng(11).normal(0, 0.1, (8, cfg.chunk_samples)).astype(np.float32)
        scores = [make_fused_classifier(load_model_runner(p, device="cuda"), cfg,
                                        device="cuda")(wave)
                  for p in (FLAGSHIP_TFLITE, out / FLAGSHIP_TFLITE.name)]
        if not np.array_equal(*scores) or not np.isfinite(scores[0]).all():
            fail("deploy: the deployed bundle does not classify as the source bundle")
        conv = Path(tmp) / "convert"
        run_verb("deploy", ["--model_path", str(CF.TFLITE), "--output_dir", str(conv)])
        files = json.loads((conv / "manifest.json").read_text())["files"]
        want = {name: committed["files"][name] for name in
                ("model_config.json", "labels.txt", "firmware/app_config.h",
                 "firmware/app_labels.h")}
        want[CF.TFLITE.name] = {"sha256": deploy._sha256(CF.TFLITE),
                                "bytes": CF.TFLITE.stat().st_size}
        if files != want:
            fail(f"deploy of the convert export: manifest files {files}, want {want}")
    counts = dict(frontend_kernel.launches)
    print(json.dumps({"deploy_phase": {
        "files": sorted(manifest["files"]), "validate_ms": [v["first_batch_ms"] for v in validated],
        "validated_shapes": [v["output_shape"] for v in validated], "kernel_launches": counts}}))
    if counts != {linear: DEPLOY_LAUNCHES} or len(validated) != 2:
        fail(f"deploy: launches {counts}, want {{{linear!r}: {DEPLOY_LAUNCHES}}}")
    return counts[linear]


# The transplant, export, codec and DDP phases (16-19 of the docstring).
TRANSPLANT_CPU_ATOL = 1e-4
EXPORT_B = 8
EXPORT_EAGER_ATOL = 1e-5
EXPORT_KERNEL_ATOL = 1e-4
CODEC_FORMATS = ("flac", "ogg", "mp3")
DDP_ROWS = 16
DDP_STEPS = 8
DDP_TIMEOUT = 300
# The two-rank step's gates and lr are the package's, which the multi-card
# dry run holds too (scripts/multichip.py: LOSS_RTOL, NORM_RTOL, STATS_RTOL,
# TENSOR_UPDATE_RTOL, UPDATE_RTOL, GATE_LR and step_gates).


def has_module(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def transplant_phase(torch, np, tmp: Path) -> dict[str, int]:
    """(16): the reference .keras route; returns {path: linear launches}."""
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner, load_model_runner
    from birdnet_stm32_tpu_torch.models.serving import classify_in_batches, make_fused_classifier
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from tests import make_torch_transplant_fixtures as TF

    linear = frontend_kernel.kernel_name("linear", "none")
    h5py = has_module("h5py")
    if h5py:
        runner = load_model_runner(TF.KERAS, device="cuda")
        model, cfg = runner.model, runner.cfg
        route = "load_model_runner (h5py)"
    else:
        print(json.dumps({"transplant_route": "h5py is absent on this machine: serving the "
                          "committed transplanted state_dict with the archive's config.json "
                          "(tests/make_torch_transplant_fixtures.py::archive_model); the "
                          "serve verb on the .keras is skipped"}))
        model, cfg = TF.archive_model(device="cuda")
        runner = TorchRunner(model, cfg, device="cuda")
        route = "archive_model (no h5py)"
    classify = make_fused_classifier(runner, cfg, device="cuda")
    requests = requests_for(np, cfg, REQUESTS)
    frontend_kernel.launches.clear()
    scores = np.concatenate([classify_in_batches(classify, r, batch_size=B)[0] for r in requests])
    counts = dict(frontend_kernel.launches)
    want = sum(-(-n // B) for n in REQUESTS)
    if counts != {linear: want}:
        fail(f"transplant: launches {counts}, want {{{linear!r}: {want}}}")
    if scores.shape != (sum(REQUESTS), 100) or not np.isfinite(scores).all():
        fail(f"transplant: scores {scores.shape}, finite {np.isfinite(scores).all()}")
    cpu_model, _ = TF.archive_model(device="cpu")
    cpu = make_fused_classifier(TorchRunner(cpu_model, cfg, device="cpu"), cfg, device="cpu")
    err = float(np.abs(cpu(requests[0]) - scores[:B]).max())
    if not err <= TRANSPLANT_CPU_ATOL:
        fail(f"transplant: card vs CPU scores differ by {err}")
    launches = {"classify": want}
    if h5py:
        audio = tmp / "transplant_audio"
        audio.mkdir()
        write_serve_files(np, audio)
        frontend_kernel.launches.clear()
        run_verb("serve", ["--model_path", str(TF.KERAS), "--audio_dir", str(audio),
                           "--results_file", str(tmp / "transplant.tsv"), "--once"])
        rows = tsv_rows(np, tmp / "transplant.tsv")
        if len(rows) != len(SERVE_FILES) or not all(np.isfinite(v).all() and v.size == 100
                                                     for _, v in rows.values()):
            fail(f"transplant: serve rows {list(rows)}")
        launches["serve"] = frontend_kernel.launches[linear]
    print(json.dumps({"transplant_phase": {"route": route, "chunks": int(scores.shape[0]),
                                           "launches": launches, "cuda_vs_cpu_max_abs": err,
                                           "top1_mean": float(scores.max(axis=1).mean())}}))
    return launches


def export_phase(torch, np, tmp: Path) -> int:
    """(17): the torch.export serving module; returns the linear kernel's
    launches (the kernel-fed classifier it is held against)."""
    from birdnet_stm32_tpu_torch.conversion import export_program as X
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
    from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
    from tests import make_torch_transplant_fixtures as TF

    linear = frontend_kernel.kernel_name("linear", "none")
    model, cfg = TF.archive_model(device="cuda")
    wave = torch.from_numpy(requests_for(np, cfg, (EXPORT_B,))[0]).cuda()
    t0 = time.perf_counter()
    blob = X.export_serving_fn(model, cfg, batch_size=EXPORT_B, device="cuda")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = X.load_serving_fn(blob)
    load_ms = (time.perf_counter() - t0) * 1e3
    got = run(wave)
    runner = TorchRunner(model, cfg, device="cuda")
    with torch.no_grad():
        eager = runner.forward(inputs_for_config(wave, cfg))
    frontend_kernel.launches.clear()
    fed = torch.from_numpy(make_fused_classifier(runner, cfg, device="cuda")(wave.cpu().numpy()))
    launches = frontend_kernel.launches[linear]
    eager_err = float((got - eager).abs().max())
    kernel_err = float((got.cpu() - fed).abs().max())
    if got.shape != (EXPORT_B, 100) or not torch.isfinite(got).all():
        fail(f"export: program output {tuple(got.shape)}")
    if not eager_err <= EXPORT_EAGER_ATOL or not kernel_err <= EXPORT_KERNEL_ATOL:
        fail(f"export: program vs eager {eager_err}, vs kernel-fed classifier {kernel_err}")
    if launches != 1:
        fail(f"export: the kernel-fed classifier launched {launches} times, want 1")
    run_ms = cuda_ms_median(torch, lambda: run(wave))
    eager_ms = cuda_ms_median(torch, lambda: runner.forward(inputs_for_config(wave, cfg)))

    t0 = time.perf_counter()
    int8_blob = X.export_int8_serving_fn(FLAGSHIP_TFLITE, cfg, batch_size=EXPORT_B,
                                         device="cuda")
    int8_export_s = time.perf_counter() - t0
    int8_run = X.load_serving_fn(int8_blob)
    fwd = build_executor(TFLiteGraph(str(FLAGSHIP_TFLITE)), EXPORT_B, device="cuda")
    int8_got, int8_ref = int8_run(wave), fwd(inputs_for_config(wave, cfg))
    if not torch.equal(int8_got, int8_ref):
        fail(f"export: INT8 program differs from the executor by "
             f"{float((int8_got - int8_ref).abs().max())}")
    int8_ms = cuda_ms_median(torch, lambda: int8_run(wave))
    int8_eager_ms = cuda_ms_median(torch, lambda: fwd(inputs_for_config(wave, cfg)))

    out = tmp / "deploy_stablehlo"
    frontend_kernel.launches.clear()
    run_verb("deploy", ["--model_path", str(FLAGSHIP_TFLITE), "--output_dir", str(out),
                        "--stablehlo"])
    launches += frontend_kernel.launches[linear]  # validate_bundle's batch
    manifest = json.loads((out / "manifest.json").read_text())
    entry = manifest["files"].get("serving_module.pt2")
    program = out / "serving_module.pt2"
    if entry is None or entry["bytes"] != program.stat().st_size:
        fail(f"deploy --stablehlo: manifest files {sorted(manifest['files'])}")
    bundle_run = X.load_serving_fn(program.read_bytes())
    waves64 = torch.from_numpy(requests_for(np, cfg, (B,))[0]).cuda()
    fwd64 = build_executor(TFLiteGraph(str(FLAGSHIP_TFLITE)), B, device="cuda")
    if not torch.equal(bundle_run(waves64), fwd64(inputs_for_config(waves64, cfg))):
        fail("deploy --stablehlo: the bundle's module differs from the executor")
    print(json.dumps({"export_phase": {
        "batch": EXPORT_B, "float_export_s": export_s, "float_load_ms": load_ms,
        "float_program_ms": run_ms, "float_eager_composition_ms": eager_ms,
        "program_vs_eager_max_abs": eager_err, "program_vs_kernel_fed_max_abs": kernel_err,
        "int8_export_s": int8_export_s, "int8_program_ms": int8_ms,
        "int8_eager_executor_ms": int8_eager_ms, "int8_bit_equal": True,
        "program_bytes": len(blob), "int8_program_bytes": len(int8_blob),
        "deploy_module_bytes": entry["bytes"], "card": card()}}))
    return launches


def codec_phase(torch, np, tmp: Path) -> dict[str, int]:
    """(18): the native audio library and the codec; returns {path: linear
    launches}."""
    from birdnet_stm32_tpu_torch.audio import io as AIO
    from birdnet_stm32_tpu_torch.audio import native
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.serving import decode_for_classify
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel

    linear = frontend_kernel.kernel_name("linear", "none")
    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    if not native.available():
        fail(f"codec: the native library did not build ({native.NATIVE.error})")
    audio = tmp / "codec_audio"
    audio.mkdir()
    write_serve_files(np, audio)
    files = [audio / f[0] for f in SERVE_FILES]
    codec = native.codec_available()
    if codec:
        rng = np.random.default_rng(7)
        for i, ext in enumerate(CODEC_FORMATS):
            t = np.arange(int(SR * (5 + 3 * i))) / SR
            y = 0.5 * np.sin(2 * np.pi * rng.uniform(800, 5000) * t * (1 + 0.05 * t))
            native.codec_encode(audio / f"tone_{i}.{ext}", y.astype(np.float32), SR)
            files.append(audio / f"tone_{i}.{ext}")
    else:
        print(json.dumps({"codec": f"libav is absent on this machine ({native.CODEC.error}): "
                          "the compressed formats are skipped; the native WAV reader and "
                          "resampler are checked and timed"}))

    def riff(path):  # the numpy reader and scipy, the library switched off
        frames = AIO._decode_frames(AIO.wav_info(path), 0, AIO.wav_info(path).frames)
        return frames.mean(axis=1).astype(np.float32)

    decode_ms = {}
    for path in files:
        if path.suffix == ".wav":
            got = native.wav_read(path)
            if not np.array_equal(got, riff(path)):
                fail(f"codec: the native WAV read of {path.name} differs from the numpy reader")
            decode_ms[path.name] = {"native_ms": host_ms(lambda: native.wav_read(path)),
                                    "riff_numpy_ms": host_ms(lambda: riff(path))}
        else:
            decode_ms[path.name] = {"codec_ms": host_ms(lambda: native.codec_decode(path))}
    x = np.random.default_rng(3).normal(0, 0.3, 48000 * 10).astype(np.float32)
    from scipy.signal import resample_poly

    resample_err = float(np.abs(native.resample_poly(x, 48000, SR) - resample_poly(x, 147, 320)).max())
    if not resample_err <= 5e-6:
        fail(f"codec: the native resampler is {resample_err} from scipy")
    chunks = [len(decode_for_classify(p, cfg)[0]) for p in files]
    frontend_kernel.launches.clear()
    out, timing = run_benchmark_verb(["--model_path", str(FLAGSHIP_TFLITE),
                                      "--audio_dir", str(audio)])
    want = sum(-(-k // B) for k in chunks) + 1
    counts = dict(frontend_kernel.launches)
    if counts != {linear: want} or out.count("[BENCH] read:") != len(files):
        fail(f"codec: benchmark launches {counts} (want {want}), "
             f"{out.count('[BENCH] read:')} files of {len(files)}")
    print(json.dumps({"codec_phase": {"libav": codec, "files": [p.name for p in files],
                                      "chunks": chunks, "decode_ms_per_file": decode_ms,
                                      "resample_vs_scipy_max_abs": resample_err,
                                      "benchmark": timing, "launches": want,
                                      "card": card()}}))
    return {"benchmark": want}


def host_ms(fn, n: int = 5) -> float:
    """Median host milliseconds of fn() over n calls after one warm-up."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def ddp_phase(torch, np, tmp: Path) -> dict[str, int]:
    """(19): data-parallel training; returns {path: linear launches}."""
    import os

    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.scripts import multichip as MC
    from tests import make_torch_transplant_fixtures as TF

    linear = frontend_kernel.kernel_name("linear", "none")
    model, cfg = TF.archive_model(device="cuda")
    rng = np.random.default_rng(5)
    frontend_kernel.launches.clear()
    x = frontend_kernel.frontend_input(
        torch.from_numpy(requests_for(np, cfg, (DDP_ROWS,))[0]).cuda(), cfg).cpu()
    feature_launches = frontend_kernel.launches[linear]
    y = torch.from_numpy((rng.random((DDP_ROWS, cfg.num_classes)) < 0.05).astype(np.float32))
    data = {"cfg": cfg.to_dict(), "state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
            "x": x, "y": y, "optimizer": "sgd", "lr": MC.GATE_LR, "steps": 1}
    torch.save(data, tmp / "ddp_in.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT)

    def worker(out: str, rank: int, world: int, port: int, backend: str):
        return subprocess.Popen([sys.executable, "-m", "tests.torch_ddp_worker",
                                 str(tmp / "ddp_in.pt"), str(tmp / out), str(rank), str(world),
                                 str(port), backend, "cuda:0"], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # (a) A NCCL world of one rank against no group, each in a process of
    # its own with deterministic algorithms (two runs of the step are
    # otherwise an ulp apart in places on the card).
    MC.wait_ranks([worker("ddp_none.pt", 0, 1, 0, "none"),
                   worker("ddp_nccl1.pt", 0, 1, MC.free_port(), "nccl")], "ddp world of one",
                  DDP_TIMEOUT)
    one, world1 = (torch.load(tmp / f, weights_only=False) for f in ("ddp_none.pt", "ddp_nccl1.pt"))
    world1_equal = world1["loss"] == one["loss"] and all(
        torch.equal(world1["variables"][k], v) for k, v in one["variables"].items())
    if not world1_equal:
        fail("ddp: a NCCL world of one changes the step")

    # (b) Two gloo processes on the one card, each on half the rows.
    port = MC.free_port()
    t0 = time.perf_counter()
    MC.wait_ranks([worker("ddp_out.pt", rank, 2, port, "gloo") for rank in (0, 1)], "ddp step",
                  DDP_TIMEOUT)
    step_s = time.perf_counter() - t0
    two = torch.load(tmp / "ddp_out.pt", weights_only=False)
    gates = MC.step_gates(two, one, data["state_dict"])
    if not gates.pop("hold"):
        fail(f"ddp: two gloo ranks vs the global-batch step: {gates}")

    # (c) `train` in two ranks (gloo: two ranks, one card), 8 steps each.
    data_dir = tmp / "data"
    args = train_args(data_dir, tmp / "ddp_run", 1, DDP_STEPS, workers="0")
    t0 = time.perf_counter()
    MC.wait_ranks(MC.spawn_ranks(["-m", "tests.torch_ddp_worker", "train", str(tmp / "ddp_rank"),
                                  *args], 2), "ddp train", DDP_TIMEOUT)
    train_s = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"ddp_rank{r}.json").read_text()) for r in (0, 1)]
    launches = {"features": feature_launches}
    for r, seen in enumerate(ranks):
        want = seen["steps"] + seen["val"]
        if seen["rc"] != 0 or seen["steps"] != DDP_STEPS or seen["launches"] != {linear: want} \
                or not np.isfinite(seen["losses"]).all():
            fail(f"ddp train rank {r}: {seen}")
        launches[f"train_rank{r}"] = want
    if ranks[0]["losses"] != ranks[1]["losses"]:
        fail("ddp train: the ranks report different global losses")
    if not (tmp / "ddp_run" / "best" / "state_dict.pt").exists():
        fail("ddp train: rank 0 wrote no best/ checkpoint")
    print(json.dumps({"ddp_phase": {
        "world_of_one_nccl_bit_equal": world1_equal, "two_rank_gloo_step_gates": gates,
        "two_rank_step_call_s": step_s, "train_two_ranks_s": train_s,
        "rank_train_s": [s["seconds"] for s in ranks], "rank_val_batches": [s["val"] for s in ranks],
        "rank_step_ms_median": [float(np.median(s["step_ms"])) for s in ranks],
        "rank_step_ms_after_first": [float(np.median(s["step_ms"][1:])) for s in ranks],
        "launches": launches, "card": card()}}))
    return launches


# The mesh phase: one batch of MESH_ROWS rows through every leg, and the
# batches it times. Float32 scores of a mesh within MESH_F32_ATOL of one
# card (each shard's smaller batch may take another cuDNN algorithm), bf16
# logits at per-row cosine >= MESH_BF16_MIN_COSINE, embeddings within
# MESH_F32_ATOL; INT8 bit-equal.
MESH_ROWS = 64
MESH_TIMED_B = (64, 256)
MESH_F32_ATOL = 1e-5
MESH_BF16_MIN_COSINE = 0.999
MESH_REPS = 5


def mesh_ingress(np, cfg) -> dict[str, tuple[dict, object]]:
    """{ingress: (make_fused_classifier kwargs, its MESH_ROWS-row batch)}:
    float32, int16 raw codes, mu-law codes and float32 at 48 kHz."""
    from birdnet_stm32_tpu_torch.models.serving import quantize_waveform_ulaw

    wave = requests_for(np, cfg, (MESH_ROWS,))[0]
    w16, _ = raw_pcm16_batch(np, cfg, MESH_ROWS)
    at48 = np.random.default_rng(48).normal(0, 0.2, (MESH_ROWS, int(cfg.chunk_duration * 48000)))
    return {"float32": ({}, wave), "int16": ({"input_dtype": "int16"}, w16),
            "ulaw": ({"input_dtype": "ulaw"}, quantize_waveform_ulaw(wave)),
            "resample48k": ({"input_sample_rate": 48000}, at48.astype(np.float32))}


def mesh_shard_kernels(torch, cfg, wave, mesh, quant) -> float:
    """Each shard's kernel output against the plain version on its card
    (the float kernel within KERNEL_TOL; the int8 entry equal to the
    executor's quantize of the float kernel, within one code of the plain
    version's on under 1 %); returns the largest float gap."""
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
        frontend_input,
        fused_spectrogram_plain,
        quantize_entry,
    )
    from birdnet_stm32_tpu_torch.parallel.mesh import shard_batch

    hop = cfg.chunk_samples // cfg.spec_width
    worst = 0.0
    for y in shard_batch(wave, mesh):
        got = frontend_input(y, cfg)[..., 0]
        plain = fused_spectrogram_plain(y, cfg.fft_length, hop, cfg.spec_width)
        worst = max(worst, (got - plain).abs().max().item())
        codes = frontend_input(y, cfg, quant=quant)
        if not torch.equal(codes, quantize_entry(got, quant)):
            fail(f"mesh: the int8 entry kernel on {y.device} != quantize(float kernel)")
        compare(codes, quantize_entry(plain, quant), True, f"int8 entry on {y.device}")
    if not worst <= KERNEL_TOL["linear"]:
        fail(f"mesh: a shard's linear kernel is {worst} from its plain version")
    return worst


def mesh_phase(torch, np) -> dict[str, int]:
    """(20): serving over a local mesh; returns {kernel name: launches}."""
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import make_embedder, make_fused_classifier
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.parallel.mesh import local_mesh, shard_batch
    from birdnet_stm32_tpu_torch.quant.tflite_import import entry_quant_params
    from tests import make_torch_convert_fixtures as CF
    from tests.int8_fixture import entry_transpose_fixture

    softmax, cfg = CF.load_model("cuda")
    logits = build_dscnn(cfg, class_activation="none", device="cuda")
    logits.load_state_dict(softmax.state_dict())
    graph = TFLiteSimRunner(FLAGSHIP_TFLITE, device="cuda").graph
    graphs = {"int8": graph, "int8_fused": entry_transpose_fixture(graph)}

    def runner(leg: str, mesh):
        kw = {"device": "cuda"} if mesh is None else {"mesh": mesh}
        if leg in graphs:
            return TFLiteSimRunner(graphs[leg], **kw)
        if leg == "float32":
            return TorchRunner(softmax, cfg, **kw)
        return TorchRunner(logits, cfg, dtype=torch.bfloat16, **kw)

    linear, linear_int8 = (frontend_kernel.kernel_name("linear", "none", quant=q)
                           for q in (False, True))
    ingress = mesh_ingress(np, cfg)
    meshes = {"width1": ["cuda:0"], "two_on_cuda0": ["cuda:0", "cuda:0"]}
    if torch.cuda.device_count() > 1:
        meshes["every_card"] = [str(d) for d in local_mesh()]
    refs = {}
    for leg in ("int8", "int8_fused", "float32", "bf16"):
        for mode, (kw, wave) in ingress.items():
            if leg in graphs or mode == "float32":
                refs[leg, mode] = make_fused_classifier(runner(leg, None), cfg, device="cuda",
                                                        **kw)(wave)
    ref_embed = make_embedder(runner("float32", None), cfg, device="cuda")(ingress["float32"][1])

    # The main path: every leg and ingress over each mesh, the counts
    # cleared just before and read just after.
    report, launches, gaps = {}, {linear: 0, linear_int8: 0}, {}
    for name, mesh in meshes.items():
        width = len(mesh)
        for (leg, mode), ref in refs.items():
            if name == "width1" and mode != "float32":
                continue
            kw, wave = ingress[mode]
            classify = make_fused_classifier(runner(leg, mesh), cfg, device="cuda",
                                             as_numpy=False, **kw)
            frontend_kernel.launches.clear()
            got = classify(wave)
            counts = dict(frontend_kernel.launches)
            kernel = linear_int8 if leg == "int8_fused" else linear
            if counts != {kernel: width}:
                fail(f"mesh {name} {leg} {mode}: launches {counts}, expected {kernel} x {width}")
            launches[kernel] += width
            if got.device != torch.device("cuda", 0) or got.shape != ref.shape:
                fail(f"mesh {name} {leg} {mode}: scores {tuple(got.shape)} on {got.device}")
            got = got.cpu().numpy()
            if not np.isfinite(got).all():
                fail(f"mesh {name} {leg} {mode}: non-finite scores")
            if name == "width1" or leg in graphs:
                held, gap = np.array_equal(got, ref), float(np.abs(got - ref).max())
            elif leg == "float32":
                gap = float(np.abs(got - ref).max())
                held = gap <= MESH_F32_ATOL
            else:
                gap = float(row_cosines(np, got, ref).min())
                held = gap >= MESH_BF16_MIN_COSINE
            gaps[f"{name}/{leg}/{mode}" + ("/min_cosine" if leg == "bf16" and name != "width1"
                                           else "")] = gap
            if not held:
                fail(f"mesh {name} {leg} {mode}: {gap} against one card")
        frontend_kernel.launches.clear()
        emb = make_embedder(runner("float32", mesh), cfg, device="cuda")(ingress["float32"][1])
        counts = dict(frontend_kernel.launches)
        if counts != {linear: width}:
            fail(f"mesh {name} embedder: launches {counts}, expected {linear} x {width}")
        launches[linear] += width
        gap = float(np.abs(emb - ref_embed).max())
        gaps[f"{name}/embedder"] = gap
        if not (gap == 0.0 if name == "width1" else gap <= MESH_F32_ATOL):
            fail(f"mesh {name} embedder: {gap} against one card")
        q = entry_quant_params(graphs["int8_fused"])
        report[f"{name}_shard_kernel_vs_plain"] = mesh_shard_kernels(
            torch, cfg, ingress["float32"][1], local_mesh(mesh), q)
    report["gaps_to_one_card"] = gaps

    # ms per batch and chunks/s per width (host clock around a classify
    # that copies its scores back, median of MESH_REPS), and the copies of
    # the row blocks alone.
    timed = {"one_card": None, **meshes}
    rates = {}
    for b in MESH_TIMED_B:
        wave = requests_for(np, cfg, (b,))[0]
        for name, mesh in timed.items():
            for leg in ("int8", "float32", "bf16"):
                classify = make_fused_classifier(runner(leg, mesh), cfg, device="cuda")
                ms = host_ms(lambda: classify(wave), MESH_REPS)
                rates[f"B{b}/{name}/{leg}"] = {"ms_per_batch": ms, "chunks_per_s": b / ms * 1e3,
                                               **device_activity(torch, lambda: classify(wave))}
            devices = local_mesh(mesh or ["cuda:0"])
            rates[f"B{b}/{name}/h2d_copies_ms"] = host_ms(
                lambda: (shard_batch(wave, devices), torch.cuda.synchronize()), MESH_REPS)
    report["timing"] = rates
    print(json.dumps({"mesh_phase": report, "widths": {k: len(v) for k, v in meshes.items()},
                      "launches": launches, "card": card()}))
    return {f"mesh/{k}": v for k, v in launches.items()}


def main() -> None:
    import tempfile

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))

    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, entry_quant_params
    from tests.int8_fixture import entry_transpose_fixture

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    timed("build", build_phase)
    timed("occupancy", occupancy_phase)
    quant = entry_quant_params(entry_transpose_fixture(TFLiteGraph(FLAGSHIP_TFLITE)))
    entries = timed("kernel", kernel_phase, torch, np, quant)
    timed("sweep", sweep_phase, torch)
    timed("perch_geometry", perch_geometry_phase, torch)
    launches = timed("slice", slice_phase, torch, np)
    flagship = ModelConfig.load(ROOT / "artifacts/flagship/bundle/model_config.json")
    int8_launches, served_conv = timed("int8", int8_phase, torch, np, flagship)
    launches.update(int8_launches)
    conv_entries = timed("int8_conv", int8_conv_phase, torch, np, served_conv)
    phase_launches = [timed("bf16", bf16_phase, torch, np, flagship),
                      timed("fuzz", fuzz_phase, torch, np)]
    timed("prepass", prepass_phase, torch, np)
    serve_launches = timed("serve", serve_phase, torch, np)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, batch = timed("train", train_phase, torch, np, flagship, Path(tmp))
        evaluate_launches = timed("evaluate", evaluate_phase, torch, np, flagship, Path(tmp))
        options_launches = timed("train_options", train_options_phase, torch, np, Path(tmp),
                                 *batch)
        convert_launches = timed("convert", convert_phase, torch, np, Path(tmp))
        deploy_launches = timed("deploy", deploy_phase, torch, np)
        transplant_launches = timed("transplant", transplant_phase, torch, np, Path(tmp))
        export_launches = timed("export", export_phase, torch, np, Path(tmp))
        codec_launches = timed("codec", codec_phase, torch, np, Path(tmp))
        ddp_launches = timed("ddp", ddp_phase, torch, np, Path(tmp))
    mesh_launches = timed("mesh", mesh_phase, torch, np)
    tile_entries = timed("tile", tile_phase, torch, np, quant, entries)
    bench_launches = timed("bench", bench_phase, torch)
    print(json.dumps({"phase_seconds": seconds}))
    linear, linear_int8 = (frontend_kernel.kernel_name("linear", "none", quant=q)
                           for q in (False, True))
    for entry in entries:
        entry["launches"] = launches.get(entry["name"], 0)
        # The bf16 and fuzz phases' launches, each run counted from zero.
        for path, counts in zip(("bf16", "fuzz"), phase_launches):
            if entry["name"] in counts:
                entry["launches"] += counts[entry["name"]]
                entry.setdefault("phase_launches", {})[path] = counts[entry["name"]]
        # The serve path's own launches, each run counted from zero.
        for path, n in serve_launches.items():
            if entry["name"] == (linear_int8 if "int8" in path else linear):
                entry["launches"] += n
                entry.setdefault("serve_launches", {})[path] = n
        # The train path's own launches (train, resume, serving the run;
        # the librosa + pwl trainer run on the features kernel).
        mel_pwl = frontend_kernel.kernel_name("mel", "pwl")
        for path, n in train_launches.items():
            if entry["name"] == (mel_pwl if path == "librosa_pwl" else linear):
                entry["launches"] += n
                entry.setdefault("train_launches", {})[path] = n
        # The evaluate, benchmark and board-test runs (linear kernel), and
        # the train options (the QAT run on librosa + pwl on the features
        # kernel, every other run on the linear kernel).
        if entry["name"] == linear:
            entry["launches"] += sum(evaluate_launches.values())
            entry["evaluate_launches"] = evaluate_launches
            # convert's card half runs no kernel (its calibration is the
            # composition); deploy's validation and bundle checks do.
            entry["launches"] += convert_launches + deploy_launches
            entry["convert_launches"] = convert_launches
            entry["deploy_launches"] = deploy_launches
            # The last slice's paths: the .keras transplant, the export's
            # kernel-fed comparison and its deploy, the native audio /
            # codec benchmark and the data-parallel runs (each rank's
            # process counted on its own).
            for key, counts in (("transplant_launches", transplant_launches),
                                ("codec_launches", codec_launches),
                                ("ddp_launches", ddp_launches)):
                entry["launches"] += sum(counts.values())
                entry[key] = counts
            entry["launches"] += export_launches
            entry["export_launches"] = export_launches
        for path, n in options_launches.items():
            if entry["name"] == (mel_pwl if path.endswith("librosa_pwl") else linear):
                entry["launches"] += n
                entry.setdefault("train_options_launches", {})[path] = n
        # Serving over a local mesh: one launch per shard per batch.
        n = mesh_launches.get(f"mesh/{entry['name']}")
        if n is not None:
            entry["launches"] += n
            entry["mesh_launches"] = n
    for entry in tile_entries:
        entry["launches"] = bench_launches.get(entry["name"], 0)
    entries += tile_entries + conv_entries
    for entry in entries:
        if entry["launches"] == 0 and entry["served_path"] is not None:
            fail(f"{entry['name']} was never launched on its served path")

    name_and_limit = card()
    print(json.dumps({"kernels": entries}))
    print(name_and_limit)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
