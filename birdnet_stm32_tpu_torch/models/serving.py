"""Fused waveform -> scores classification (port of models/serving.py).

make_fused_classifier runs ingress, frontend and model back to back on one
device. The ingress takes the waveform batch as float32, as int16 codes
with a scale column, or as int8 mu-law codes, dequantizes it on the device
and, when the batch arrives at another rate than the model's, resamples it
there (ops/resample.py), in that order, as the JAX package does. On CUDA
the spectrogram frontends (hybrid, librosa with any mag_scale, log_mel,
mfcc) are the hand-written fused kernels
(ops/kernels/frontend_kernel.py::frontend_input), on the CPU their plain
version. The composition (ops/frontend.inputs_for_config) serves only what
the kernels' dispatch excludes, as in the JAX package: 2*hop < n_fft, or
the 'raw' frontend. There is no kernel on/off switch.

Every device leg (float32, bf16, INT8; with or without a mesh) runs one
loop: each row block's features go to the runner's forward_block, the
leg's one model call (models/runners.py). With a TFLiteSimRunner (the INT8
leg) that is the bit-exact integer executor: when the runner's graph takes
the int8 entry (`runner.entry_quant`) and a kernel serves the frontend
(frontend_kernel.kernel_serves), the kernel's int8-entry epilogue
quantizes straight into the executor's entry tensor; otherwise the float
features feed the graph's own entry QUANTIZE. Both give the same scores,
bit for bit. A TFLiteInterpreterRunner (graphs that are not full-int8)
runs the frontend on the device and the interpreter on the host.

A TorchRunner with dtype=torch.bfloat16 is the bf16 leg: on CUDA its
features are the cast of the kernel's float32 output (the kernels serve
every stft_precision), on the CPU the cast of the plain version's; the
composition (raw, or a geometry the kernels do not take) emits bf16
features itself through the bf16-I/O STFT, as the JAX package does.

decode_for_classify and chunks_for_classify_int16 turn one WAV into the
chunk batch each ingress takes (audio/io.py), through the decoded-waveform
cache when given a cache_dir.

A runner with a mesh (models/runners.py, `mesh=`: local devices, as the
JAX runners' mesh) serves each batch over it: the batch is split into
equal row blocks in mesh order, and each block goes through the ingress,
the frontend (the kernel on that block's card: one launch per block) and
that card's replica or executor, issued card after card in one loop (CUDA
runs each card's queue on its own). The scores are gathered in row order:
on mesh[0], the classifier's device, or block by block to the host. A
batch whose rows do not divide over the mesh raises ValueError. The
interpreter leg runs on the host, with no mesh.

A classify call opens the serving spans (utils/tracing.py).
"""

from __future__ import annotations

import struct
import time

import numpy as np
import torch

from birdnet_stm32_tpu_torch.data.worker import ulaw_encode
from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.evaluation.metrics import chunks_for_file
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input, kernel_serves
from birdnet_stm32_tpu_torch.ops.resample import resample_chunk_batch
from birdnet_stm32_tpu_torch.parallel.mesh import gather, shard_batch
from birdnet_stm32_tpu_torch.utils.tracing import EGRESS, FRONTEND, INGRESS, MODEL, REQUEST, span

INPUT_DTYPES = (None, "float32", "int16", "ulaw")
# Under jax.jit, XLA divides by a constant as a multiply by its float32
# reciprocal; the port writes those reciprocals out (never a CUDA tensor
# divided by a Python scalar, which CUDA would also turn into a multiply,
# but the CPU would not).
_INV_127 = float(np.float32(1.0) / np.float32(127.0))
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_LOG1P_MU = float(np.float32(np.log1p(255.0)))


def quantize_waveform_int16(wave: np.ndarray) -> np.ndarray:
    """[-1, 1] float waveforms -> [B, T+1] int16 codes + scale column 32767,
    for half-bandwidth shipping (make_fused_classifier(input_dtype='int16')).

    This requantizing path costs one PCM16 LSB (~3e-5) of waveform error;
    mono PCM16 sources at the model rate ship their raw codes instead
    (audio/io.load_chunks_int16, bit-exact against the float32 path).
    """
    codes = np.clip(np.round(wave * 32767.0), -32768, 32767).astype(np.int16)
    scale = np.full((codes.shape[0], 1), 32767, np.int16)
    return np.concatenate([codes, scale], axis=1)


def _dequantize_int16(w: torch.Tensor) -> torch.Tensor:
    """[B, T+1] int16 codes + scale column -> [B, T] float32 waveforms.

    scale = |last column| (-32768 encodes a peak of 32768). The quotient is
    a division of two float32 tensors, which IEEE rounds correctly on the
    CPU and on CUDA, so it equals the host's numpy division bit for bit
    (the JAX package needs _div_exact_int only because TPU division is
    1 ulp off). The scale stays a [B, 1] tensor on the device: never a
    Python scalar, which CUDA would turn into a reciprocal multiply.
    """
    codes = w[:, :-1].float()
    scale = torch.clamp_min(w[:, -1:].float().abs(), 1.0)
    return codes / scale


def _dequantize_ulaw(q: torch.Tensor) -> torch.Tensor:
    """[B, T] int8 mu-law codes -> [B, T] float32 waveforms (inverse of
    data/worker.ulaw_encode: mu = 255 companding on a symmetric 8-bit
    grid). A quarter of the float32 host-to-device bytes at ~2.2 % relative
    waveform error; not bit-exact. The JAX source's / 127 and / 255 are
    multiplies by float32 reciprocals, as jitted XLA computes them."""
    f = q.float() * _INV_127
    return torch.sign(f) * torch.expm1(f.abs() * _LOG1P_MU) * _INV_255


def quantize_waveform_ulaw(wave: np.ndarray) -> np.ndarray:
    """[-1, 1] float waveforms [B, T] -> [B, T] int8 mu-law codes for
    quarter-bandwidth shipping (host twin of _dequantize_ulaw)."""
    return ulaw_encode(np.asarray(wave, np.float32))


def make_ingress(cfg, input_sample_rate: int | None = None, input_dtype: str | None = None):
    """The device-side ingress of make_fused_classifier: a batch in the
    input_dtype's layout on the device -> [B, cfg.chunk_samples] float32.
    Dequantize first, then resample (when input_sample_rate differs from
    cfg.sample_rate)."""
    if input_dtype not in INPUT_DTYPES:
        raise ValueError(f"Invalid input_dtype: {input_dtype!r}")
    dequant = {"int16": _dequantize_int16, "ulaw": _dequantize_ulaw}.get(input_dtype)
    resample = input_sample_rate is not None and input_sample_rate != cfg.sample_rate

    def ingress(wave: torch.Tensor) -> torch.Tensor:
        if dequant is not None:
            wave = dequant(wave)
        if resample:
            wave = resample_chunk_batch(wave, input_sample_rate, cfg)
        return wave.float().contiguous()

    return ingress


def _precision_and_dtype(runner, stft_precision: str | None):
    """The JAX default rule: 'high' for a runner with a dtype (bf16), else
    'highest'; bf16 features only off 'highest'."""
    dtype = getattr(runner, "dtype", None)
    if stft_precision is None:
        stft_precision = "high" if dtype is not None else "highest"
    return stft_precision, (dtype if stft_precision != "highest" else None)


def make_fused_classifier(runner, cfg, input_sample_rate: int | None = None,
                          as_numpy: bool = True, input_dtype: str | None = None,
                          stft_precision: str | None = None,
                          device: str | torch.device = "cuda"):
    """waveform batch -> scores [B, C] on `device`.

    Args:
        runner: TorchRunner (float32 or bf16) or TFLiteSimRunner on
            `device` (with a mesh, mesh[0]: each batch is served over the
            mesh, module docstring), or a TFLiteInterpreterRunner (host).
        cfg: ModelConfig (audio + model geometry).
        input_sample_rate: When set and != cfg.sample_rate, batches arrive
            at this rate ([B, chunk_duration * input_sample_rate]) and are
            resampled on the device before the frontend.
        as_numpy: True returns np.ndarray; False returns the scores tensor
            on `device`, without a copy to the host (the interpreter leg
            always returns np.ndarray). Under a mesh the blocks' scores are
            gathered on `device`, or with True copied to the host block by
            block.
        input_dtype: None / 'float32': float32 waveforms [B, T]. 'int16':
            [B, T+1] int16 codes + scale column (audio/io.load_chunks_int16
            raw PCM codes, bit-exact against the float path, or
            quantize_waveform_int16). 'ulaw': [B, T] int8 mu-law codes
            (quantize_waveform_ulaw; not bit-exact).
        stft_precision: 'highest' | 'high' | 'default' (ops/stft.py). None
            picks 'high' for a runner with a dtype (bf16), else 'highest',
            as the JAX package does; off 'highest' a bf16 runner gets bf16
            features. The kernels compute the same float32 for each.
        device: Where ingress, frontend and model run; default CUDA (raises
            if there is none). Under a mesh it must name mesh[0].
    """
    stft_precision, feat_dtype = _precision_and_dtype(runner, stft_precision)
    dev = resolve_device(device)
    runner_dev = getattr(runner, "device", None)
    if runner_dev is not None and runner_dev != dev:
        raise ValueError(f"runner is on {runner_dev}, classifier on {dev}")
    mesh = getattr(runner, "mesh", None) or [dev]
    ingress = make_ingress(cfg, input_sample_rate, input_dtype)
    host_dtype = np.float32 if input_dtype in (None, "float32") else None

    def blocks_in(wave) -> list[torch.Tensor]:
        """The batch's row blocks through the ingress, block k on mesh[k]."""
        return [ingress(w) for w in shard_batch(np.asarray(wave, host_dtype), mesh)]

    if as_numpy:
        def out(blocks):
            return np.concatenate([s.cpu().numpy() for s in blocks])
    else:
        def out(blocks):
            return gather(blocks, dev)

    if hasattr(runner, "forward_block"):
        # The kernel quantizes into the executor's entry tensor when the
        # graph takes it and a kernel serves this frontend at this geometry.
        entry_q = runner.entry_quant if kernel_serves(cfg, cfg.chunk_samples) else None

        @torch.no_grad()
        def classify(wave):
            with span(REQUEST):
                with span(INGRESS):
                    blocks = blocks_in(wave)
                scores = []
                for w in blocks:
                    # frontend_input and the runner each hold TF32 off where
                    # it matters; a bf16 runner casts whatever features it
                    # is given.
                    with span(FRONTEND):
                        feats = frontend_input(w, cfg, quant=entry_q,
                                               stft_precision=stft_precision,
                                               feature_dtype=feat_dtype)
                    with span(MODEL):
                        scores.append(runner.forward_block(feats))
                with span(EGRESS):
                    return out(scores)

        classify.entry_quant = entry_q
        return classify
    if not as_numpy:
        print("[warn] runner has no device-side graph (TFLite interpreter): "
              "classify returns host arrays and blocks")

    @torch.no_grad()
    def classify(wave) -> np.ndarray:
        with span(REQUEST):
            with span(INGRESS):
                (w,) = blocks_in(wave)
            with span(FRONTEND):
                feats = frontend_input(w, cfg, stft_precision=stft_precision)
            with span(MODEL):
                scores = runner.predict(feats.cpu().numpy())
            with span(EGRESS):
                return np.asarray(scores)

    return classify


def make_embedder(runner, cfg, stft_precision: str | None = None,
                  device: str | torch.device = "cuda"):
    """waveform batch [B, T] float32 -> embeddings [B, emb] float32 (float
    runner only, float32 or bf16): the DS-CNN's pooled pre-head vector.
    INT8 and interpreter artifacts expose only class scores. stft_precision
    follows make_fused_classifier's rule, and so does a runner's mesh: each
    row block runs on its card's replica."""
    if not hasattr(runner, "model"):
        raise TypeError("embeddings need a float (Torch) runner; "
                        ".tflite artifacts expose only class scores")
    stft_precision, feat_dtype = _precision_and_dtype(runner, stft_precision)
    dev = resolve_device(device)
    if runner.device != dev:
        raise ValueError(f"runner is on {runner.device}, embedder on {dev}")
    dtype = getattr(runner, "dtype", None)
    mesh = runner.mesh or [dev]

    def block(w: torch.Tensor) -> torch.Tensor:
        feats = frontend_input(w.contiguous(), cfg, stft_precision=stft_precision,
                               feature_dtype=feat_dtype)
        if dtype is not None:
            feats = feats.to(dtype)  # a no-op when the frontend emitted bf16
        with full_fp32():
            _, emb = runner.replicas[w.device](feats, return_embeddings=True)
        return emb.float()

    @torch.no_grad()
    def embed(wave) -> np.ndarray:
        embs = [block(w) for w in shard_batch(np.asarray(wave, np.float32), mesh)]
        return np.concatenate([e.cpu().numpy() for e in embs])

    return embed


def decode_for_classify(path, cfg, overlap: float = 0.0, max_duration=None,
                        device_resample: bool = False, cache_dir: str | None = None,
                        int16_io: bool = False, ulaw_io: bool = False):
    """One header probe and one decode for the serving drivers
    (cli/serve.py, cli/benchmark.py): (chunks, src_rate, audio_seconds,
    read_ms).

    chunks is [N, T] float32; with int16_io [N, T+1] int16 codes + scale
    column (raw codes for mono PCM16 WAVs at the decode rate, bit-exact
    after the device dequant; requantized otherwise); with ulaw_io [N, T]
    int8 mu-law codes. device_resample decodes at the file's own rate
    (src_rate), for a classifier made with input_sample_rate=src_rate.
    cache_dir routes the float decode through the decoded-waveform cache
    (audio/io.py::cached_waveform). Thread-safe: it shares no state.
    """
    if int16_io and ulaw_io:
        raise ValueError("int16_io and ulaw_io are mutually exclusive")
    from birdnet_stm32_tpu_torch.audio.io import audio_info

    t0 = time.perf_counter()
    src_rate = cfg.sample_rate
    duration = 0.0
    try:
        info = audio_info(path)
        if info.sample_rate > 0:
            duration = info.frames / float(info.sample_rate)
            if device_resample:
                src_rate = int(info.sample_rate)
    except (OSError, ValueError, struct.error):
        pass  # unparseable header: the decode below yields 0 chunks
    if int16_io:
        chunks = chunks_for_classify_int16(str(path), cfg, overlap,
                                           max_duration=max_duration, sample_rate=src_rate,
                                           cache_dir=cache_dir)
    else:
        chunks = chunks_for_file(str(path), cfg, overlap, max_duration=max_duration,
                                 sample_rate=src_rate, cache_dir=cache_dir)
        if ulaw_io:
            chunks = quantize_waveform_ulaw(chunks)
    if duration <= 0.0 and len(chunks):
        duration = len(chunks) * (cfg.chunk_duration - overlap) + overlap
    return chunks, src_rate, duration, (time.perf_counter() - t0) * 1000.0


def chunks_for_classify_int16(path, cfg, overlap: float = 0.0, max_duration=None,
                              sample_rate=None, cache_dir: str | None = None) -> np.ndarray:
    """[N, T+1] int16 chunks + scale column for one file.

    Mono PCM16 WAVs at the decode rate ship their raw codes (window peak in
    the scale column, bit-exact after the device dequant); everything else
    decodes to float (through the cache when given cache_dir) and
    requantizes (quantize_waveform_int16: scale 32767, one PCM16 LSB of
    error).
    """
    from birdnet_stm32_tpu_torch.audio.io import load_chunks_int16

    rate = sample_rate or cfg.sample_rate
    chunks = load_chunks_int16(path, sample_rate=rate, chunk_duration=cfg.chunk_duration,
                               chunk_overlap=overlap, max_duration=max_duration)
    if chunks is None:
        chunks = quantize_waveform_int16(
            chunks_for_file(path, cfg, overlap, max_duration=max_duration, sample_rate=rate,
                            cache_dir=cache_dir))
    return chunks


def classify_in_batches(classify, chunks: np.ndarray, batch_size: int):
    """Run [N, T] chunks through a fixed-batch classifier, padding the tail.

    Returns:
        ([N, C] scores, seconds spent in classify calls).
    """
    scores, dt = [], 0.0
    for i in range(0, len(chunks), batch_size):
        wave = chunks[i : i + batch_size]
        n = wave.shape[0]
        if n < batch_size:
            wave = np.pad(wave, ((0, batch_size - n), (0, 0)))
        t0 = time.perf_counter()
        scores.append(np.asarray(classify(wave))[:n])
        dt += time.perf_counter() - t0
    return np.concatenate(scores), dt


def top_predictions(pooled: np.ndarray, top_k: int, score_threshold) -> list[int]:
    """Top-k class indices; ranks past the first must clear score_threshold
    (a scalar, or a per-class [C] vector). The top-1 is always kept."""
    thr = np.broadcast_to(np.asarray(score_threshold, np.float32), pooled.shape)
    top = np.argsort(pooled)[::-1][:top_k]
    return [int(i) for rank, i in enumerate(top)
            if rank == 0 or pooled[i] >= thr[i]]


def make_classifier_cache(runner, cfg, as_numpy: bool = True, verbose: bool = False,
                          input_dtype: str | None = None,
                          device: str | torch.device = "cuda"):
    """classifier_for(rate) -> fused classifier, made once per distinct
    source sample rate (rates equal to cfg.sample_rate skip the resampler);
    each serves over the runner's mesh, as make_fused_classifier does."""
    cache: dict[int, object] = {}

    def classifier_for(rate: int):
        if rate not in cache:
            if verbose and rate != cfg.sample_rate:
                print(f"[info] making a device-resample classifier for {rate} Hz input")
            cache[rate] = make_fused_classifier(
                runner, cfg, as_numpy=as_numpy,
                input_sample_rate=rate if rate != cfg.sample_rate else None,
                input_dtype=input_dtype, device=device)
        return cache[rate]

    return classifier_for
