"""Firmware header generation: ModelConfig + labels -> C headers (port of
deploy/headers.py, a copy).

`app_config.h` carries the audio / frontend / class geometry for the
reference STM32N6 firmware, `app_labels.h` the class-name string table:
the same define names, frontend mode encoding and escaping rules. The
headers' banner names the generator as the JAX package does, so a bundle
either package builds from the same inputs has the same bytes (and the
same manifest hashes).
"""

from __future__ import annotations

from pathlib import Path

from birdnet_stm32_tpu_torch.config import ModelConfig

# Frontend string -> firmware mode define (gen_app_config.py _FRONTEND_MAP).
# 'mfcc' and 'log_mel' are deliberately ABSENT: the firmware's precomputed
# mode computes a plain mel spectrogram on the M55 — feeding that to a model
# trained on MFCCs (DCT) or log1p-mel would run garbage on device. The
# reference map silently defaults unknown names to HYBRID; here they fail.
_FRONTEND_DEFINE = {
    "hybrid": "APP_FRONTEND_HYBRID",
    "raw": "APP_FRONTEND_RAW",
    "librosa": "APP_FRONTEND_PRECOMPUTED",
}


def generate_app_config_h(cfg: ModelConfig) -> str:
    """Contents of app_config.h for the reference firmware."""
    chunk = cfg.chunk_duration
    chunk_literal = str(int(chunk)) if chunk == int(chunk) else str(chunk)
    if cfg.audio_frontend not in _FRONTEND_DEFINE:
        raise ValueError(
            f"audio_frontend={cfg.audio_frontend!r} has no firmware mode: "
            "the STM32N6 firmware computes hybrid/raw/mel features only "
            f"(deployable frontends: {sorted(_FRONTEND_DEFINE)})")
    frontend_define = _FRONTEND_DEFINE[cfg.audio_frontend]
    # Consume the sidecar's hop_length field directly, like the reference's
    # firmware/gen_app_config.py:36 — ModelConfig guarantees at construction
    # that it equals the training-time contract chunk_samples // spec_width.
    hop = cfg.hop_length

    board = "\n".join(
        f"#ifndef {name}\n#define {name}{' ' * max(1, 32 - 8 - len(name))}{value}\n#endif"
        for name, value in (
            ("NUCLEO_N6_CONFIG", 0),
            ("USE_MCU_DCACHE", 1),
            ("USE_MCU_ICACHE", 1),
            ("USE_EXTERNAL_MEMORY_DEVICES", 1),
            ("USE_UART_BAUDRATE", 921600),
            ("USE_USB_PACKET_SIZE", 512),
            ("USE_OVERDRIVE", 0),
        )
    )

    return f"""\
/* Auto-generated by birdnet_stm32_tpu.deploy.headers — do not edit.
 *
 * Source: model_config.json
 * Target: STM32N6570-DK (Cortex-M55 + NPU), reference firmware layout.
 */

#ifndef APP_CONFIG_H
#define APP_CONFIG_H

/* --- NPU_Validation board support defines --------------------------------- */
{board}

/* --- Audio parameters (from model_config.json) ---------------------------- */
#define APP_SAMPLE_RATE       {cfg.sample_rate}
#define APP_CHUNK_DURATION    {chunk_literal}
#define APP_CHUNK_SAMPLES     {cfg.chunk_samples}
#define APP_FFT_LENGTH        {cfg.fft_length}
#define APP_FFT_BINS          (APP_FFT_LENGTH / 2 + 1)
#define APP_HOP_LENGTH        {hop}
#define APP_SPEC_WIDTH        {cfg.spec_width}
#define APP_NUM_MELS          {cfg.num_mels}
#define APP_NUM_CLASSES       {cfg.num_classes}

/* --- Audio frontend mode --------------------------------------------------- */
#define APP_FRONTEND_HYBRID       0
#define APP_FRONTEND_RAW          1
#define APP_FRONTEND_PRECOMPUTED  2
#define APP_AUDIO_FRONTEND        {frontend_define}

/* --- SD card paths ---------------------------------------------------------- */
#define APP_AUDIO_DIR         "audio"
#define APP_RESULTS_FILE      "results.txt"

/* --- Inference --------------------------------------------------------------- */
#define APP_TOP_K             5
#define APP_SCORE_THRESHOLD   0.01f

#endif /* APP_CONFIG_H */
"""


def generate_app_labels_h(labels: list[str]) -> str:
    """Contents of app_labels.h: escaped class-name string table."""
    rows = "\n".join(
        '    "{}",'.format(label.replace("\\", "\\\\").replace('"', '\\"'))
        for label in labels
    )
    return f"""\
/* Auto-generated by birdnet_stm32_tpu.deploy.headers — do not edit. */
#ifndef APP_LABELS_H
#define APP_LABELS_H

#define APP_NUM_CLASSES_ACTUAL {len(labels)}

static const char * const APP_LABELS[] = {{
{rows}
}};

#endif /* APP_LABELS_H */
"""


def write_headers(cfg: ModelConfig, labels: list[str], out_dir: str | Path) -> tuple[Path, Path]:
    """Write both headers; returns their paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg_path = out_dir / "app_config.h"
    labels_path = out_dir / "app_labels.h"
    cfg_path.write_text(generate_app_config_h(cfg))
    labels_path.write_text(generate_app_labels_h(labels))
    return cfg_path, labels_path
