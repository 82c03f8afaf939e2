"""PyTorch port, the CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has none; tests/conftest.py configures
JAX, so run it there with:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

The INT8 leg: each int8-entry specialisation must equal the executor's
quantize of the float kernel's output bit for bit, and its plain version
(quantize of the plain float features) within one code on fewer than 1 %
of codes (the allowance of tests/test_pallas.py); the CUDA integer executor
must equal the golden scores and its own CPU run bit for bit.

Tolerances: 1e-5 for the linear kernel and 2e-5 for the other epilogues
(the JAX package's gates, tests/test_pallas.py) on [0, 1]-normalized
features. Kernel and plain version both compute in float32 (the plain
version with TF32 off) and differ in summation order. The linear mode in
dB is outside those gates and gets 1e-4: a bin 80 dB below the peak holds
a magnitude 1e-4 of it, so a summation-order error relative to the frame
energy grows ~1e4-fold in that bin's dB (measured 7.6e-5 on an H100).

The tile grid (grid="tile") computes each frame and every sum as the sample
grid does, so it must equal the sample-grid kernel bit for bit, float32
and int8.

The kernels' FFT takes n_fft as a power of two from 64 to 2048; each size
is held against the plain version, and any other n_fft raises ValueError
on a CUDA tensor.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    frontend_input,
    fused_spectrogram,
    fused_spectrogram_plain,
    kernel_name,
    quantize_entry,
)
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    TFLiteGraph,
    build_executor,
    entry_quant_params,
)
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture, flagship_features

GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_int8_flagship_scores.npz"

COMBOS = [("linear", "none"), ("mel", "none"), ("mel", "pwl"), ("mel", "pcen"),
          ("mel", "db"), ("log_mel", "none"), ("mfcc", "none"), ("linear", "pwl"),
          ("linear", "db"), ("linear", "pcen")]
TOLERANCE = {("linear", "none"): 1e-5, ("linear", "db"): 1e-4}
FLAGSHIP = dict(sample_rate=22050, n_fft=512, mel_bins=64, spec_width=256, n_mfcc=20)
# tests/test_pallas.py's small geometry: n_fft 256, hop 250, 32 frames (mfcc 33).
SMALL = dict(sample_rate=8000, n_fft=256, mel_bins=32, spec_width=32, n_mfcc=13)
TILES = (2, 4, 8, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _wave(seed, B, T):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 0.5, (B, T)).astype(np.float32)).cuda()


def _check(y, mode, mag, geometry, T, launches=1):
    """Kernel vs plain version on y; the kernel launches `launches` times."""
    name = kernel_name(mode, mag)
    before = frontend_kernel.launches[name]
    for _ in range(launches):
        got = fused_spectrogram(y, mode=mode, mag_scale=mag, **geometry)
    torch.cuda.synchronize()
    assert frontend_kernel.launches[name] == before + launches
    hop = T // geometry["spec_width"]
    full = 1 + T // hop
    n_frames = full if mode == "mfcc" else min(geometry["spec_width"], full)
    with full_fp32():
        ref = fused_spectrogram_plain(
            y, geometry["n_fft"], hop, n_frames, mode=mode, mag_scale=mag,
            sample_rate=geometry["sample_rate"], mel_bins=geometry["mel_bins"],
            n_mfcc=geometry["n_mfcc"], out_w=min(geometry["spec_width"], n_frames))
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    tol = TOLERANCE.get((mode, mag), 2e-5)
    err = (got - ref).abs().max().item()
    assert err <= tol, f"{name}: max abs {err} > {tol}"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda):
    """The linear (hybrid) kernel at the flagship geometry."""
    _check(_wave(9, 8, 66150), "linear", "none", FLAGSHIP, 66150)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", COMBOS[1:])
def test_epilogue_kernel_matches_plain_on_card(cuda, mode, mag):
    """Each features-kernel specialisation at the flagship geometry; the
    linear ones keep their 257 bins in the scratch, not shared memory."""
    _check(_wave(4, 8, 66150), mode, mag, FLAGSHIP, 66150)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", COMBOS)
def test_kernel_matches_plain_at_small_geometry(cuda, mode, mag):
    """tests/test_pallas.py's small geometry (n_fft 256, hop 250, 32 mels,
    13 mfcc), three launches in a row: each kernel leaves its arrival
    counters at zero for the next."""
    _check(_wave(5, 3, 8000), mode, mag, SMALL, 8000, launches=3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mel", "mfcc"])
def test_more_than_64_mels_on_card(cuda, mode):
    """96 mels: each lane of a warp sums three mels of every frame."""
    geometry = {**FLAGSHIP, "mel_bins": 96}
    _check(_wave(6, 4, 66150), mode, "pwl" if mode == "mel" else "none", geometry, 66150)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", COMBOS)
def test_int8_epilogue_on_card(cuda, mode, mag):
    """Each int8-entry specialisation at the flagship geometry, twice in a
    row: bit-equal to quantize(the float kernel's output), and within one
    code of quantize(the plain version) on fewer than 1 % of codes."""
    y = _wave(10, 4, 66150)
    quant = entry_quant_params(entry_transpose_fixture(TFLiteGraph(FLAGSHIP_TFLITE)))
    kw = dict(mode=mode, mag_scale=mag, **FLAGSHIP)
    name = kernel_name(mode, mag, quant=True)
    before = frontend_kernel.launches[name]
    got = [fused_spectrogram(y, quant=quant, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert frontend_kernel.launches[name] == before + 2
    floats = fused_spectrogram(y, **kw)
    bins, out_w = floats.shape[1:]
    assert got[0].shape == (4, 1, out_w, bins) and got[0].dtype == torch.int8
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], quantize_entry(floats, quant))
    T, hop = y.shape[1], y.shape[1] // FLAGSHIP["spec_width"]
    n_frames = 1 + T // hop if mode == "mfcc" else FLAGSHIP["spec_width"]
    with full_fp32():
        plain = quantize_entry(fused_spectrogram_plain(
            y, FLAGSHIP["n_fft"], hop, n_frames, mode=mode, mag_scale=mag,
            sample_rate=FLAGSHIP["sample_rate"], mel_bins=FLAGSHIP["mel_bins"],
            n_mfcc=FLAGSHIP["n_mfcc"], out_w=FLAGSHIP["spec_width"]), quant)
    diff = (got[0].int() - plain.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() < 0.01


@pytest.mark.cuda
def test_int8_executor_matches_golden_on_card(cuda):
    """The CUDA integer executor on the golden's features: bit-equal to the
    JAX executor's scores (which equal the TFLite interpreter's)."""
    x = torch.from_numpy(flagship_features(8)).cuda()
    got = build_executor(TFLiteGraph(FLAGSHIP_TFLITE), 8, device="cuda")(x).cpu().numpy()
    np.testing.assert_array_equal(got, np.load(GOLDEN)["scores"])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_int8_executor_matches_cpu_on_card(cuda, fused):
    """CUDA vs CPU executor on chirp features from the linear kernel: the
    flagship graph on float features, or the fixture graph on the int8
    kernel's entry tensor; bit-equal scores."""
    cfg = ModelConfig.load(Path(__file__).resolve().parents[1]
                           / "artifacts/flagship/bundle/model_config.json")
    t = np.arange(cfg.chunk_samples) / cfg.sample_rate
    f0 = np.random.default_rng(11).uniform(500.0, 6000.0, (6, 1))
    wave = torch.from_numpy((0.5 * np.sin(2 * np.pi * f0 * t * (1 + 0.3 * t))).astype(np.float32))
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    quant = None
    if fused:
        graph = entry_transpose_fixture(graph)
        quant = entry_quant_params(graph)
    feats = frontend_input(wave.cuda(), cfg, quant=quant)
    got = build_executor(graph, 6, device="cuda", prequantized_input=fused)(feats)
    ref = build_executor(graph, 6, device="cpu", prequantized_input=fused)(feats.cpu())
    assert torch.isfinite(got).all() and got.shape == (6, 100)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["small", "flagship"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode,mag", COMBOS)
def test_tile_grid_equals_sample_grid_on_card(cuda, mode, mag, int8, geometry):
    """Every tile of TILES at B=16 equals the sample-grid kernel bit for
    bit, float32 and int8. Small geometry: a 64-row strip holds two
    samples' 32 frames (mfcc: 33, strips straddle samples); flagship: 256
    frames (mfcc: 257, one strip in five straddles)."""
    geometry, T = (SMALL, 8000) if geometry == "small" else (FLAGSHIP, 66150)
    y = _wave(12, 16, T)
    quant = (entry_quant_params(entry_transpose_fixture(TFLiteGraph(FLAGSHIP_TFLITE)))
             if int8 else None)
    kw = dict(mode=mode, mag_scale=mag, quant=quant, **geometry)
    sample = fused_spectrogram(y, **kw)
    name = kernel_name(mode, mag, int8, "tile")
    for tile in TILES:
        before = frontend_kernel.launches[name]
        got = fused_spectrogram(y, grid="tile", batch_tile=tile, **kw)
        torch.cuda.synchronize()
        assert frontend_kernel.launches[name] == before + 1
        assert got.shape == sample.shape and got.dtype == sample.dtype
        assert torch.equal(got, sample), (
            f"{name} tile {tile}: max abs {(got.float() - sample.float()).abs().max().item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "pwl"), ("mfcc", "none"),
                                      ("linear", "pcen")])
def test_tile_grid_leaves_counters_at_zero(cuda, mode, mag):
    """After a tile-grid launch whose strips straddle samples, every
    per-sample arrival counter is back at zero (blocks that arrive at two
    samples count once at each)."""
    y = _wave(13, 8, 8000)
    fused_spectrogram(y, mode=mode, mag_scale=mag, grid="tile", batch_tile=4, **SMALL)
    torch.cuda.synchronize()
    counters = [buf for (dev, _), buf in frontend_kernel._arrival_counters.items()
                if dev == y.device]
    assert counters and all(int(buf.count_nonzero()) == 0 for buf in counters)


@pytest.mark.cuda
def test_tile_grid_contract_on_card(cuda):
    """B=6 does not split into groups of 4: ValueError before any launch."""
    before = frontend_kernel.launches.total()
    with pytest.raises(ValueError, match="batch_tile"):
        fused_spectrogram(_wave(14, 6, 8000), grid="tile", batch_tile=4, **SMALL)
    assert frontend_kernel.launches.total() == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "pwl"), ("mfcc", "none")])
def test_fft_sizes_on_card(cuda, n_fft, mode, mag):
    """Every n_fft the FFT takes (one template per size; 2048's strip tile
    takes sub-strips), at hop n_fft // 2 on 16000 samples, against the
    plain version, twice in a row."""
    hop, T = n_fft // 2, 16000
    n_frames = 1 + T // hop if mode == "mfcc" else T // hop
    out_w = T // hop
    kw = dict(sample_rate=16000, mel_bins=32, n_mfcc=13)
    y = _wave(15, 3, T)
    name = kernel_name(mode, mag)
    before = frontend_kernel.launches[name]
    got = [fused_spectrogram(y, mode=mode, mag_scale=mag, n_fft=n_fft, spec_width=out_w, hop=hop,
                             n_frames=n_frames, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert frontend_kernel.launches[name] == before + 2
    with full_fp32():
        ref = fused_spectrogram_plain(y, n_fft, hop, n_frames, mode=mode, mag_scale=mag,
                                      out_w=out_w, **kw)
    for g in got:
        assert g.shape == ref.shape and torch.isfinite(g).all()
        err = (g - ref).abs().max().item()
        assert err <= TOLERANCE.get((mode, mag), 2e-5), f"{name} n_fft {n_fft}: max abs {err}"
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [384, 96, 4096])
def test_fft_size_contract_on_card(cuda, n_fft):
    """An n_fft the FFT does not take: ValueError before any launch."""
    before = frontend_kernel.launches.total()
    with pytest.raises(ValueError, match="power of two"):
        fused_spectrogram(_wave(16, 2, 16000), n_fft=n_fft, spec_width=16000 // n_fft)
    assert frontend_kernel.launches.total() == before


@pytest.mark.cuda
@pytest.mark.parametrize("mel_bins", [96, 128])
@pytest.mark.parametrize("mode,mag", [("mel", "none"), ("mel", "pcen"), ("mfcc", "none")])
def test_mel_counts_on_card(cuda, mode, mag, mel_bins):
    """96 and 128 mels (more than one 32-lane round of mels per frame) at
    the flagship geometry: the float kernel against the plain version, and
    the int8 one bit-equal to quantize(the float kernel's output)."""
    geometry = {**FLAGSHIP, "mel_bins": mel_bins}
    y = _wave(17, 4, 66150)
    _check(y, mode, mag, geometry, 66150)
    quant = entry_quant_params(entry_transpose_fixture(TFLiteGraph(FLAGSHIP_TFLITE)))
    kw = dict(mode=mode, mag_scale=mag, **geometry)
    got = fused_spectrogram(y, quant=quant, **kw)
    assert torch.equal(got, quantize_entry(fused_spectrogram(y, **kw), quant))


# --- The serve path: ingress, resampler, CLI (no new kernel) -----------------

FLAGSHIP_CONFIG = Path(__file__).resolve().parents[1] / "artifacts/flagship/bundle/model_config.json"


@pytest.mark.cuda
def test_dequantize_int16_whole_domain_on_card(cuda):
    """Every int16 code against every scale code 1..32767, -32768 (a peak of
    32768) and 0 (divides by 1): 2^31 quotients, each equal to the float64
    quotient rounded to float32 (for 16-bit integer operands that double
    rounding is exact), so CUDA's division is IEEE-correct here."""
    from birdnet_stm32_tpu_torch.models.serving import _dequantize_int16

    codes = torch.arange(-32768, 32768, device="cuda", dtype=torch.int32).to(torch.int16)
    scales = torch.cat([torch.arange(1, 32768, device="cuda", dtype=torch.int32),
                        torch.tensor([-32768, 0], device="cuda", dtype=torch.int32)])
    w = torch.empty(512, codes.numel() + 1, dtype=torch.int16, device="cuda")
    w[:, :-1] = codes
    for lo in range(0, scales.numel(), 512):
        s = scales[lo : lo + 512]
        ws = w[: s.numel()]
        ws[:, -1] = s.to(torch.int16)
        got = _dequantize_int16(ws)
        den = s.double().abs().clamp_min(1.0)[:, None]
        ref = (codes.double()[None] / den).float()
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), f"scales {lo}.."


@pytest.mark.cuda
def test_dequantize_ulaw_on_card(cuda):
    from birdnet_stm32_tpu_torch.models.serving import _dequantize_ulaw

    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)[None]
    got = _dequantize_ulaw(q.cuda()).cpu()
    assert (got - _dequantize_ulaw(q)).abs().max().item() <= 2e-7


@pytest.mark.cuda
@pytest.mark.parametrize("sr_in", [48000, 44100, 16000])
def test_resampler_on_card(cuda, sr_in):
    """The polyphase conv1d on the card against the CPU, B=64 chunks of 3 s
    to 22.05 kHz: within 2e-5."""
    from birdnet_stm32_tpu_torch.ops.resample import resample_chunk_batch

    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    x = torch.from_numpy(np.random.default_rng(12).normal(0, 0.3, (64, 3 * sr_in))
                         .astype(np.float32))
    got = resample_chunk_batch(x.cuda(), sr_in, cfg)
    ref = resample_chunk_batch(x, sr_in, cfg)
    assert got.shape == ref.shape == (64, cfg.chunk_samples)
    assert (got.cpu() - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_int16_ingress_bit_equal_on_card(cuda, fused):
    """Raw PCM16 codes + peak through the int16 ingress score exactly as the
    host's peak-normalised floats, on both INT8 legs on the card."""
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier

    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    runner = TFLiteSimRunner(entry_transpose_fixture(graph) if fused else graph, device="cuda")
    rng = np.random.default_rng(13)
    peaks = np.array([900, 20000, 32767, 32768])
    codes = np.clip(np.round(rng.normal(0, 1, (4, cfg.chunk_samples)) * peaks[:, None] / 3),
                    -peaks[:, None], np.minimum(peaks, 32767)[:, None]).astype(np.int32)
    codes[:, 7] = np.where(peaks == 32768, -32768, peaks)
    scale = np.where(peaks == 32768, -32768, peaks)[:, None]
    w16 = np.concatenate([codes, scale], axis=1).astype(np.int16)
    floats = (codes.astype(np.float32) / np.float32(32768.0)
              / (peaks.astype(np.float32)[:, None] / np.float32(32768.0)))
    f = make_fused_classifier(runner, cfg, device="cuda")
    i = make_fused_classifier(runner, cfg, input_dtype="int16", device="cuda")
    assert (f.entry_quant is not None) == fused
    np.testing.assert_array_equal(i(w16), f(floats))


@pytest.mark.cuda
def test_serve_once_on_card_matches_cpu(cuda, tmp_path):
    """`serve --once` on CUDA against --device cpu on the same files: the
    same files in the same order, pooled scores at cosine >= 0.999 (the
    kernel and its plain version can move an INT8 entry code)."""
    from birdnet_stm32_tpu_torch.__main__ import main
    from birdnet_stm32_tpu_torch.audio.io import save_wav

    audio_dir = tmp_path / "audio"
    rng = np.random.default_rng(14)
    for name, sr, seconds in (("a.wav", 22050, 4.5), ("b.wav", 48000, 3.0), ("c.wav", 22050, 3.0)):
        t = np.arange(int(sr * seconds)) / sr
        save_wav(0.5 * np.sin(2 * np.pi * rng.uniform(800, 5000) * t * (1 + 0.3 * t))
                 + rng.normal(0, 0.05, t.size), audio_dir / name, sr)
    rows = {}
    for device in ("cuda", "cpu"):
        for extra in ([], ["--int16_io"], ["--device_resample"]):
            results = tmp_path / f"{device}{''.join(extra)}.txt"
            assert main(["serve", "--model_path", str(FLAGSHIP_TFLITE), "--audio_dir",
                         str(audio_dir), "--results_file", str(results), "--once",
                         "--batch_size", "4", "--device", device, *extra]) == 0
            rows[device, tuple(extra)] = [line.split("\t") for line in
                                          results.read_text().splitlines()]
    for extra in ([], ["--int16_io"], ["--device_resample"]):
        got, ref = rows["cuda", tuple(extra)], rows["cpu", tuple(extra)]
        assert [r[0] for r in got] == [r[0] for r in ref] == ["a.wav", "b.wav", "c.wav"]
        for g, r in zip(got, ref):
            a, b = np.array(g[1:], float), np.array(r[1:], float)
            assert a.shape == (100,) and a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999


# --- Every model the serving dispatch accepts: the executor's other op
# kinds, requant='fast', the nine fuzz configurations and the bf16 leg. ---


def _row_cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.cuda
@pytest.mark.parametrize("requant", ["exact", "fast"])
def test_op_graphs_on_card_match_cpu(cuda, requant):
    """Each tiny op graph (tests/int8_op_graphs.py) on the card equals the
    port's CPU executor, which tier-1 holds bit-equal to the JAX one;
    SOFTMAX's exp and sum may move a code by one (the fuzz gate)."""
    from birdnet_stm32_tpu_torch.quant import tflite_import as P
    from tests.int8_op_graphs import KINDS, op_graph, op_inputs
    from tests.torch_fuzz_fixtures import MIN_EXACT_SHARE, ONE_QUANTUM, within_one_quantum

    x = op_inputs(5)
    for kind in KINDS:
        graph = op_graph(P, kind)
        ref = build_executor(graph, 5, device="cpu", requant=requant)(torch.from_numpy(x))
        got = build_executor(graph, 5, device="cuda", requant=requant)(
            torch.from_numpy(x).cuda()).cpu()
        if kind == "softmax":
            err, exact = within_one_quantum(got.numpy(), ref.numpy())
            assert err <= ONE_QUANTUM and exact >= MIN_EXACT_SHARE, (kind, err, exact)
        else:
            assert torch.equal(got, ref), kind


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(9))
def test_fuzz_configs_on_card(cuda, i):
    """The committed graph on its committed features equals the JAX golden
    (exact and fast), and every tensor the CUDA executor computes equals
    the CPU executor's (tests/torch_fuzz_fixtures.py::executor_tensors_match:
    the goldens are one constant per graph in 7 of 9 configs, the int8
    logits inside vary). The float32 leg is within 1e-5 of the JAX scores
    and its logits within LOGIT_SPREAD_RTOL x 10 of the row spread of the
    CPU logits (another summation order); the bf16 leg at cosine >= 0.999
    of the JAX bf16 scores, and its logits at BF16_LOGIT_MIN_COSINE of the
    CPU bf16 logits. tests/test_torch_fuzz_gates.py shows each logit and
    tensor gate fails on a constant and a class-shuffled output."""
    from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner
    from tests.torch_fuzz_fixtures import (
        LOGIT_SPREAD_RTOL,
        MIN_EXACT_SHARE,
        ONE_QUANTUM,
        bf16_logits_match,
        executor_tensors_match,
        has_float_faithful_ops,
        load,
        spread_error,
        within_one_quantum,
    )

    f = load(i)
    graph = TFLiteGraph(f.tflite)
    x = torch.from_numpy(f.features).cuda()
    for requant, ref in (("exact", f.int8_exact), ("fast", f.int8_fast)):
        got = build_executor(graph, len(f.features), device="cuda", requant=requant)(x)
        err, exact = within_one_quantum(got.cpu().numpy(), ref)
        assert exact == 1.0 or (has_float_faithful_ops(graph) and err <= ONE_QUANTUM
                                and exact >= MIN_EXACT_SHARE), (f.label, requant, err, exact)
        vals = build_executor(graph, len(f.features), device="cuda", requant=requant,
                              return_all=True)(x)
        cpu = build_executor(graph, len(f.features), device="cpu", requant=requant,
                             return_all=True)(torch.from_numpy(f.features))
        assert executor_tensors_match(vals, cpu, graph) == [], (f.label, requant)
    cfg = ModelConfig.from_dict(f.cfg)
    model = build_dscnn(cfg, class_activation=f.class_activation, device="cuda")
    model.load_state_dict(flax_to_state_dict(f.variables), strict=True)
    np.testing.assert_allclose(TorchRunner(model, cfg, device="cuda").predict(f.features),
                               f.float_f32, atol=1e-5)
    r16 = TorchRunner(model, cfg, device="cuda", dtype=torch.bfloat16)
    assert _row_cosines(r16.predict(f.features), f.float_bf16).min() >= 0.999
    logits = {}
    for dev in ("cuda", "cpu"):
        m = build_dscnn(cfg, class_activation="none", device=dev)
        m.load_state_dict(flax_to_state_dict(f.variables), strict=True)
        logits[dev] = [TorchRunner(m, cfg, device=dev, dtype=dt).predict(f.features)
                       for dt in (None, torch.bfloat16)]
    assert spread_error(logits["cuda"][0], logits["cpu"][0]) <= 10 * LOGIT_SPREAD_RTOL
    assert bf16_logits_match(logits["cuda"][1], logits["cpu"][1])


@pytest.mark.cuda
def test_bf16_features_are_the_cast_of_the_kernel(cuda):
    """frontend_input(feature_dtype=bf16) on CUDA launches the kernel at any
    stft_precision and returns the cast of its float32 output."""
    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    y = _wave(21, 4, cfg.chunk_samples)
    ref = frontend_input(y, cfg)
    name = kernel_name("linear", "none")
    for precision in ("highest", "high", "default"):
        before = frontend_kernel.launches[name]
        got = frontend_input(y, cfg, stft_precision=precision, feature_dtype=torch.bfloat16)
        assert frontend_kernel.launches[name] == before + 1
        assert got.dtype == torch.bfloat16 and torch.equal(got, ref.to(torch.bfloat16))


@pytest.mark.cuda
def test_bf16_flagship_on_card(cuda):
    """The bf16 leg at full width: the linear kernel once per batch, scores
    float32 at cosine >= 0.999 of the fp32 leg and of the CPU bf16 path."""
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier

    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    model = init_model(build_dscnn(cfg, device="cuda"), seed=3)
    wave = np.random.default_rng(22).normal(0, 0.2, (8, cfg.chunk_samples)).astype(np.float32)
    name = kernel_name("linear", "none")
    before = frontend_kernel.launches[name]
    s16 = make_fused_classifier(TorchRunner(model, cfg, device="cuda", dtype=torch.bfloat16),
                                cfg, device="cuda")(wave)
    assert frontend_kernel.launches[name] == before + 1
    s32 = make_fused_classifier(TorchRunner(model, cfg, device="cuda"), cfg, device="cuda")(wave)
    cpu = build_dscnn(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    c16 = make_fused_classifier(TorchRunner(cpu, cfg, device="cpu", dtype=torch.bfloat16), cfg,
                                device="cpu")(wave)
    assert s16.dtype == np.float32 and np.isfinite(s16).all()
    assert _row_cosines(s16, s32).min() >= 0.999
    assert _row_cosines(s16, c16).min() >= 0.999


# --- Training (the `train` entry point): the batcher's kernel feed and one
# train step on the card against the port's CPU path. ---

TINY_TRAIN = dict(sample_rate=4000, num_mels=16, spec_width=32, fft_length=128,
                  chunk_duration=1.0, embeddings_size=32, num_classes=3,
                  class_names=["a", "b", "c"], audio_frontend="hybrid", mag_scale="pwl",
                  alpha=0.25, use_se=False, use_inverted_residual=False, dropout_rate=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_step_on_card_matches_cpu(cuda, optimizer):
    """One train step from the same weights on the same int16 batch (no
    augmentation, dropout 0, L2 on): the batcher launches the linear kernel
    once, its features within 1e-5 of the CPU's plain version. Both steps
    then train on the card's features: loss within 1e-4 and grad norm
    within 5e-3 relative; BN statistics within 1e-3
    relative. SGD: each tensor's update within 5e-2 and the whole update
    within 1e-2 in L2 norm (a train-mode BN's gradients are mostly
    cancellation, so the backends' summation orders show as 1-3 % on some
    tensors, chip_smoke.py). Adam's sign(g)-like first step (|g| below
    ~1e-7 gives an update of size lr whatever its sign): 99 % of entries
    within 1e-2 of lr."""
    import copy

    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer

    cfg = ModelConfig(**TINY_TRAIN)
    rng = np.random.default_rng(31)
    codes = rng.integers(-20000, 20000, (16, cfg.chunk_samples)).astype(np.int16)
    scale = np.abs(codes.astype(np.int32)).max(axis=1, keepdims=True).astype(np.int16)
    wave = np.concatenate([codes, scale], axis=1)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    batcher = make_train_batcher(cfg, spec_augment=False, mixup_probability=0.0,
                                 input_dtype="int16")
    gpu = init_model(build_dscnn(cfg, class_activation="none", device="cuda"), seed=5)
    for m in gpu.modules():  # the blocks' SpatialDropout too
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    models = {"cuda": gpu, "cpu": copy.deepcopy(gpu).to("cpu")}
    name = kernel_name("linear", "none")
    n0 = frontend_kernel.launches[name]
    xg, yg = batcher(None, torch.as_tensor(wave).cuda(), torch.as_tensor(labels).cuda())
    assert frontend_kernel.launches[name] == n0 + 1
    xc, _ = batcher(None, torch.as_tensor(wave), torch.as_tensor(labels))
    assert (xg.cpu() - xc).abs().max() <= 1e-5
    # Both steps train on the card's features: the gates below measure the
    # step alone.
    out = {}
    for dev, model in models.items():
        before = {k: v.clone() for k, v in model.state_dict().items()}
        tx = build_optimizer(optimizer, 1e-3, gradient_clip_norm=1.0)
        step = make_train_step(model, tx, make_loss_fn())
        _, m = step(TrainState.create(model, tx), xg.to(dev), yg.to(dev))
        after = model.state_dict()
        out[dev] = (m, {k: (after[k] - before[k]).cpu() for k in after
                        if after[k].is_floating_point()})
    (mg, ug), (mc, uc) = out["cuda"], out["cpu"]
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 5e-3 * float(mc["grad_norm"])
    moved = [k for k in uc if "running" not in k and uc[k].norm() > 0]
    for k in uc:
        if "running" in k:
            scale_k = models["cpu"].state_dict()[k].abs().max()
            assert (ug[k] - uc[k]).abs().max() <= 1e-3 * scale_k, k
        elif optimizer == "sgd" and k in moved:
            assert (ug[k] - uc[k]).norm() <= 5e-2 * uc[k].norm(), k
    if optimizer == "sgd":
        diff = torch.cat([(ug[k] - uc[k]).flatten() for k in moved])
        assert diff.norm() <= 1e-2 * torch.cat([uc[k].flatten() for k in moved]).norm()
    else:
        d = torch.cat([(ug[k] - uc[k]).flatten() for k in uc if "running" not in k])
        assert (d.abs() <= 1e-5).float().mean() >= 0.99


@pytest.mark.cuda
def test_train_cli_on_card(cuda, tmp_path):
    """`train` on CUDA (the default device) on a seeded WAV folder: one
    linear-kernel launch per train step and per validation batch, then the
    run directory served by `serve` on the card."""
    from birdnet_stm32_tpu_torch.__main__ import main
    from birdnet_stm32_tpu_torch.audio.io import save_wav

    data = tmp_path / "data"
    rng = np.random.default_rng(32)
    for ci, cls in enumerate(["a", "b", "c", "noise"]):
        for i in range(4):
            t = np.arange(int(4000 * rng.uniform(1.5, 3.0))) / 4000
            save_wav(0.5 * np.sin(2 * np.pi * (300 + 400 * ci) * t) + rng.normal(0, 0.05, t.size),
                     data / cls / f"{i}.wav", 4000)
    args = ["train", "--data_path_train", str(data), "--run_dir", str(tmp_path / "run"),
            "--sample_rate", "4000", "--chunk_duration", "1.0", "--fft_length", "128",
            "--num_mels", "16", "--spec_width", "32", "--alpha", "0.25",
            "--embeddings_size", "32", "--no_se", "--no_inverted_residual", "--epochs", "2",
            "--steps_per_epoch", "3", "--batch_size", "8", "--num_workers", "0"]
    name = kernel_name("linear", "none")
    frontend_kernel.launches.clear()
    assert main(args) == 0
    # 16 files, 3 for validation (one chunk each): one validation batch.
    assert dict(frontend_kernel.launches) == {name: 2 * (3 + 1)}
    results = tmp_path / "served.txt"
    assert main(["serve", "--model_path", str(tmp_path / "run"), "--audio_dir",
                 str(data / "a"), "--results_file", str(results), "--once"]) == 0
    rows = [line.split("\t") for line in results.read_text().splitlines()]
    assert len(rows) == 4 and all(len(r) == 4 for r in rows)


@pytest.mark.cuda
def test_evaluate_and_benchmark_on_card(cuda, tmp_path):
    """`evaluate` of the committed bundle on CUDA against --device cpu on
    the same files: pooled scores at cosine >= 0.999 per file, one linear
    launch per batch of 4 and nothing else; `benchmark` on CUDA, serial and
    --pipeline 2: a [BENCH] line per file and the same top-1."""
    import contextlib
    import io

    from birdnet_stm32_tpu_torch.__main__ import main
    from birdnet_stm32_tpu_torch.audio.io import save_wav
    from birdnet_stm32_tpu_torch.evaluation import metrics

    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    data = tmp_path / "data"
    rng = np.random.default_rng(33)
    for ci, cls in enumerate(cfg.class_names[:3]):
        for i in range(2):
            t = np.arange(int(22050 * rng.uniform(3.0, 7.0))) / 22050
            save_wav(0.5 * np.sin(2 * np.pi * (500 + 700 * ci) * t) + rng.normal(0, 0.05, t.size),
                     data / cls / f"{i}.wav", 22050)
    real, seen = metrics.evaluate, {}

    def spy(*a, **k):
        out = real(*a, **k)
        seen[k["device"].type] = out
        return out

    metrics.evaluate = spy
    try:
        for device in ("cuda", "cpu"):
            frontend_kernel.launches.clear()
            assert main(["evaluate", "--model_path", str(FLAGSHIP_TFLITE), "--data_path_test",
                         str(data), "--output_dir", str(tmp_path / device), "--batch_size", "4",
                         "--device", device]) == 0
            if device == "cuda":
                chunks = seen["cuda"][0]["total_chunks"]
                assert dict(frontend_kernel.launches) == {kernel_name("linear", "none"):
                                                          -(-chunks // 4)}
    finally:
        metrics.evaluate = real
    assert seen["cuda"][1] == [{**r, "scores": s["scores"]}
                               for r, s in zip(seen["cpu"][1], seen["cuda"][1])]
    assert _row_cosines(seen["cuda"][3], seen["cpu"][3]).min() >= 0.999
    tops = []
    for extra in ([], ["--pipeline", "2"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["benchmark", "--model_path", str(FLAGSHIP_TFLITE), "--audio_dir",
                         str(data), "--batch_size", "4", *extra]) == 0
        assert out.getvalue().count("[BENCH] read:") == 6 and "=== DONE ===" in out.getvalue()
        tops.append([line.split("top: ")[1].split(" (")[0]
                     for line in out.getvalue().splitlines() if line.startswith("file: ")])
    assert tops[0] == tops[1]


# --- The convert and deploy verbs: the card half of the convert chain on
# the committed export (tests/goldens/torch_convert), and a deployed bundle.
# chip_smoke.py's convert and deploy phases run the same checks. ---


@pytest.mark.cuda
def test_convert_chain_on_card(cuda, tmp_path):
    """Calibration features (the composition) on the card within 1e-6 of the
    CPU's with the same kept count (chip_smoke.py's CONVERT_FEATURE_TOL); the committed export's executor
    bit-equal card vs CPU; the float runner card vs CPU within 1e-5;
    validate_runners on the card within 1e-4 of the CPU's and within 1e-3
    of the committed report's cosine_mean."""
    import json

    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.quant.validate import validate_runners
    from tests import make_torch_convert_fixtures as CF

    model, cfg = CF.load_model("cpu")
    data = tmp_path / "data"
    CF.write_train_folder(data, cfg.class_names)
    x = {dev: CF.calibration_inputs(data, cfg, dev) for dev in ("cuda", "cpu")}
    assert x["cuda"].shape == x["cpu"].shape
    assert float(np.abs(x["cuda"] - x["cpu"]).max()) <= 1e-6
    xv = CF.validation_subset(x["cuda"])
    quant = {dev: TFLiteSimRunner(CF.TFLITE, device=dev) for dev in ("cuda", "cpu")}
    np.testing.assert_array_equal(quant["cuda"].predict(xv[:32]), quant["cpu"].predict(xv[:32]))
    floats = {"cpu": TorchRunner(model, cfg, device="cpu"),
              "cuda": TorchRunner(CF.load_model("cuda")[0], cfg, device="cuda")}
    np.testing.assert_allclose(floats["cuda"].predict(xv[:32]), floats["cpu"].predict(xv[:32]),
                               rtol=0, atol=1e-5)
    stats = {dev: validate_runners(floats[dev], quant[dev], xv) for dev in ("cuda", "cpu")}
    for k, v in stats["cuda"].items():
        assert abs(v - stats["cpu"][k]) <= 1e-4, k
    report = json.loads(CF.REPORT.read_text())
    assert abs(stats["cuda"]["cosine_mean"] - report["validation"]["cosine_mean"]) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "pwl"), ("mfcc", "none")])
def test_get_spectrogram_from_audio_on_card(cuda, mode, mag):
    """The host spectrogram API runs on the card by default, within 1e-5 of
    the CPU (the composition's gate against JAX), at the flagship geometry."""
    from birdnet_stm32_tpu_torch.audio.spectrogram import get_spectrogram_from_audio

    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    y = np.random.default_rng(12).normal(0, 0.1, cfg.chunk_samples).astype(np.float32)
    kw = dict(sample_rate=cfg.sample_rate, n_fft=cfg.fft_length, mel_bins=cfg.num_mels,
              spec_width=cfg.spec_width, mag_scale=mag, mode=mode)
    got = get_spectrogram_from_audio(y, **kw)
    ref = get_spectrogram_from_audio(y, device="cpu", **kw)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_deploy_on_card(cuda, tmp_path):
    """deploy on CUDA: the manifest's hashes equal the committed
    manifest.json; validate_bundle launches the linear kernel once; the
    deployed bundle classifies bit-equal to the source bundle."""
    import json

    from birdnet_stm32_tpu_torch.__main__ import main as verb
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier

    bundle = FLAGSHIP_TFLITE.parent
    out = tmp_path / "bundle"
    name = kernel_name("linear", "none")
    before = frontend_kernel.launches[name]
    assert verb(["deploy", "--model_path", str(FLAGSHIP_TFLITE), "--output_dir", str(out)]) == 0
    assert frontend_kernel.launches[name] == before + 1
    got = json.loads((out / "manifest.json").read_text())
    assert got == json.loads((bundle / "manifest.json").read_text())
    cfg = ModelConfig.load(bundle / "model_config.json")
    wave = np.random.default_rng(5).normal(0, 0.1, (4, cfg.chunk_samples)).astype(np.float32)
    scores = [make_fused_classifier(load_model_runner(p, device="cuda"), cfg, device="cuda")(wave)
              for p in (FLAGSHIP_TFLITE, out / FLAGSHIP_TFLITE.name)]
    np.testing.assert_array_equal(*scores)
