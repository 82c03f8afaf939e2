"""The frozen arithmetic against hand counts at the flagship's shapes."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from gpubench.yardstick.macs import model_macs
from gpubench.yardstick.peaks import HBM_BYTES_PER_S, OPS_PER_S
from gpubench.yardstick.roofline import frontend_bound

ROOT = Path(__file__).resolve().parents[2]
FLAGSHIP = json.loads((ROOT / "gpubench/configs/flagship-int8.json").read_text())


def test_macs_hand_count():
    # The mel mixer and pwl over 64 mels x 256 frames, then the stem at
    # 64 x 128 and each DS block: depthwise 9 * c + BN c, pointwise c_in *
    # c_out + BN c_out per output position; the head 256 x 100.
    total = 257 * 64 * 256 + 4 * 64 * 256
    total += (9 * 16 + 16) * 64 * 128
    h, w, cin = 64, 128, 16
    for cout, reps in ((32, 2), (64, 3), (128, 4), (256, 2)):
        for b in range(reps):
            if b == 0:
                h, w = math.ceil(h / 2), math.ceil(w / 2)
            total += h * w * (9 * cin + cin + cin * cout + cout)
            cin = cout
    total += 256 * 100
    assert model_macs(FLAGSHIP) == total == 27_296_768


def test_frontend_bound_hand_count_linear_b64():
    # 64 chunks of 66150 float32 samples read, 64 x 257 x 256 float32
    # features written, at 3.35 TB/s; the FFT route's operations at 67
    # TFLOP/s are less.
    n_bytes = 4.0 * 64 * 66150 + 4.0 * 64 * 257 * 256
    ops = 64 * 256 * (2.5 * 512 * 9 + 512 + 4 * 257 + 257 * 4)
    ms, which = frontend_bound("linear", "none", rows=64, samples=66150, n_fft=512,
                               sample_rate=22050, mel_bins=64, n_mfcc=20, spec_width=256)
    assert which == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3, rel=1e-12)
    assert ops / 67e12 * 1e3 < ms


def test_frontend_bound_int8_entry_writes_one_byte_a_code():
    ms, _ = frontend_bound("linear", "none", rows=64, samples=66150, n_fft=512,
                           sample_rate=22050, mel_bins=64, n_mfcc=20, spec_width=256,
                           int8=True)
    assert ms == pytest.approx((4.0 * 64 * 66150 + 64 * 257 * 256) / 3.35e12 * 1e3)


def test_peaks_are_the_data_sheet():
    assert HBM_BYTES_PER_S == 3.35e12
    assert OPS_PER_S["int8"] == 1979e12 and OPS_PER_S["bfloat16"] == 989e12
