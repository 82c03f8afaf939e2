"""Model weights -> TFLite via a BN-fused TensorFlow forward pass (port of
conversion/export_tflite.py).

The export builds the inference graph in TF ops from the Flax-layout tree
that models/convert.py::state_dict_to_flax makes of the port's state_dict,
with every BatchNorm folded into the preceding conv in numpy float32. The
ops, their order and the folding are the JAX package's, so the same weights
and the same representative array give the same flatbuffer bytes.

TensorFlow is imported inside build_tf_forward and convert_to_tflite only:
the module imports without it.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.blocks import BN_EPS, make_divisible
from birdnet_stm32_tpu_torch.models.dscnn import BASE_FILTERS, BASE_REPEATS


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def fuse_bn(kernel: np.ndarray, bn_p: dict, bn_s: dict, channel_axis: int = -1,
            eps: float = BN_EPS) -> tuple[np.ndarray, np.ndarray]:
    """Fold inference-mode BatchNorm into the preceding (bias-free) conv.

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv(x; W * s) + (beta - mean * s),  s = gamma / sqrt(var + eps)

    Args:
        kernel: Conv kernel; `channel_axis` indexes output channels.
        bn_p: {'scale': gamma, 'bias': beta} (params collection).
        bn_s: {'mean', 'var'} (batch_stats collection).

    Returns:
        (fused kernel, bias) as float32 numpy arrays.
    """
    gamma, beta = _np(bn_p["scale"]), _np(bn_p["bias"])
    mean, var = _np(bn_s["mean"]), _np(bn_s["var"])
    s = gamma / np.sqrt(var + eps)
    shape = [1] * kernel.ndim
    shape[channel_axis] = s.shape[0]
    return _np(kernel) * s.reshape(shape), beta - mean * s


def build_tf_forward(variables: dict, cfg: ModelConfig,
                     class_activation: str = "softmax") -> Callable:
    """A TF-ops forward pass over `cfg.input_shape()` inputs.

    Weights are captured as tf constants; BN is pre-fused. Returns a python
    callable suitable for tf.function / TFLiteConverter.
    """
    import tensorflow as tf

    P = variables["params"]
    S = variables.get("batch_stats", {})

    def const(x):
        return tf.constant(_np(x))

    def conv_bn_relu6(x, name, strides, act=True):
        k, b = fuse_bn(P[f"{name}_conv"]["kernel"], P[f"{name}_bn"], S[f"{name}_bn"])
        x = tf.nn.conv2d(x, const(k), strides=[1, *strides, 1], padding="SAME")
        x = tf.nn.bias_add(x, const(b))
        return tf.nn.relu6(x) if act else x

    def pw_bn(x, name, act):
        """1x1 pointwise conv + fused BN (+ optional ReLU6)."""
        k, b = fuse_bn(P[name]["kernel"], P[f"{name}_bn"], S[f"{name}_bn"])
        x = tf.nn.conv2d(x, const(k), strides=[1, 1, 1, 1], padding="SAME")
        x = tf.nn.bias_add(x, const(b))
        return tf.nn.relu6(x) if act else x

    def dw_bn_relu6(x, name, strides):
        # Flax grouped-conv kernel (3, 3, 1, C) -> TF depthwise (3, 3, C, 1).
        k, b = fuse_bn(P[name]["kernel"], P[f"{name}_bn"], S[f"{name}_bn"])
        k = np.transpose(k, (0, 1, 3, 2))
        x = tf.nn.depthwise_conv2d(x, const(k), strides=[1, *strides, 1], padding="SAME")
        x = tf.nn.bias_add(x, const(b))
        return tf.nn.relu6(x)

    def se(x, name):
        s = tf.reduce_mean(x, axis=(1, 2), keepdims=True)
        s = tf.nn.relu(tf.linalg.matmul(s, const(P[f"{name}_reduce"]["kernel"])))
        s = tf.math.sigmoid(tf.linalg.matmul(s, const(P[f"{name}_expand"]["kernel"])))
        return x * s

    def mag_scale(y, method):
        m = P["audio_frontend"]["mag"] if "audio_frontend" in P and "mag" in P["audio_frontend"] else {}
        if method == "none":
            return y
        if method == "db":
            return 10.0 * tf.math.log(tf.maximum(y, 1e-6)) / math.log(10.0)
        if method == "pwl":
            out = const(m["pwl_k0"]) * y
            for i in range(1, 4):
                out = out + const(m[f"pwl_k{i}"]) * tf.nn.relu(
                    const(m[f"pwl_shift{i}_w"]) * y + const(m[f"pwl_shift{i}_b"]))
            return out
        if method == "pcen":
            y0 = tf.nn.relu(y - const(m["pcen_agc"]) * y)
            b1 = const(m["pcen_k1"]) * y0
            b2 = const(m["pcen_k2mk1"]) * tf.nn.relu(
                const(m["pcen_shift_w"]) * y0 + const(m["pcen_shift_b"]))
            return tf.nn.relu(b1 + b2)
        raise ValueError(f"Invalid mag_scale: {method!r}")

    frontend_mode = ("precomputed"
                     if cfg.audio_frontend in ("librosa", "mfcc", "log_mel")
                     else cfg.audio_frontend)

    def frontend(x):
        if frontend_mode == "precomputed":
            return x[:, :, : cfg.spec_width, :]
        if frontend_mode == "hybrid":
            y = tf.transpose(x[:, :, : cfg.spec_width, 0], (0, 2, 1))  # [B, W, F]
            fe = P["audio_frontend"]
            if "mel_mixer" in fe:
                mixer = fe["mel_mixer"]
            else:
                # learn_mel_scale models: materialize the triangular basis
                # from the trained segment logits as the export-time mixer.
                import torch

                from birdnet_stm32_tpu_torch.models.frontend_layer import tri_mel_matrix

                mixer = tri_mel_matrix(torch.from_numpy(_np(fe["mel_seg_logits"])),
                                       cfg.sample_rate, cfg.fft_length,
                                       cfg.num_mels).numpy()
            y = tf.linalg.matmul(y, const(mixer))
            y = tf.nn.relu(y)
            y = y / (tf.reduce_max(y, axis=(1, 2), keepdims=True) + 1e-6)
            y = mag_scale(y, cfg.mag_scale)
            return tf.transpose(y, (0, 2, 1))[..., None]  # [B, M, W, 1]
        if frontend_mode == "raw":
            T, W = cfg.chunk_samples, cfg.spec_width
            k_t, stride_t = 16, int(math.ceil(T / float(W)))
            pad_total = max(0, stride_t * (W - 1) + k_t - T)
            fe = P["audio_frontend"]
            k, b = fuse_bn(fe["raw_fb"]["kernel"], fe["raw_fb_bn"],
                           S["audio_frontend"]["raw_fb_bn"])
            y = tf.pad(x[:, :T, :], [[0, 0], [pad_total // 2, pad_total - pad_total // 2], [0, 0]])
            y = tf.nn.conv1d(y, const(k), stride=stride_t, padding="VALID")
            y = tf.nn.relu6(tf.nn.bias_add(y, const(b)))
            y = mag_scale(y, cfg.mag_scale)
            return tf.transpose(y, (0, 2, 1))[..., None]
        raise ValueError(frontend_mode)

    def forward(x):
        x = frontend(x)
        x = conv_bn_relu6(x, "stem", (1, 2))

        for si, (bf, br) in enumerate(zip(BASE_FILTERS, BASE_REPEATS), start=1):
            out_ch = make_divisible(int(bf * cfg.alpha), 8)
            reps = max(1, int(math.ceil(br * cfg.depth_multiplier)))
            for bi in range(1, reps + 1):
                strides = (2, 2) if bi == 1 else (1, 1)
                in_ch = int(x.shape[-1])
                if cfg.use_inverted_residual:
                    n = f"stage{si}_ir{bi}"
                    y = pw_bn(x, f"{n}_expand", act=True)
                    y = dw_bn_relu6(y, f"{n}_dw", strides)
                    if cfg.use_se:
                        y = se(y, f"{n}_se")
                    y = pw_bn(y, f"{n}_project", act=False)
                    x = x + y if strides == (1, 1) and in_ch == out_ch else y
                else:
                    n = f"stage{si}_ds{bi}"
                    y = dw_bn_relu6(x, f"{n}_dw", strides)
                    y = pw_bn(y, f"{n}_pw", act=False)
                    y = x + y if strides == (1, 1) and in_ch == out_ch else y
                    x = tf.nn.relu6(y)
                    if cfg.use_se:
                        x = se(x, f"stage{si}_se{bi}")

        emb_ch = make_divisible(cfg.embeddings_size, 8)
        if int(x.shape[-1]) != emb_ch:
            x = conv_bn_relu6(x, "emb", (1, 1))

        if cfg.use_attention_pooling:
            b_, h_, w_, c_ = x.shape
            flat = tf.reshape(x, (-1, int(h_) * int(w_), int(c_)))
            score = tf.linalg.matmul(flat, const(P["attn_pool_score"]["kernel"]))
            attn = tf.nn.softmax(score, axis=1)
            emb = tf.reduce_sum(flat * attn, axis=1)
        else:
            emb = tf.reduce_mean(x, axis=(1, 2))

        y = tf.linalg.matmul(emb, const(P["pred"]["kernel"]))
        y = tf.nn.bias_add(y, const(P["pred"]["bias"]))
        if class_activation == "softmax":
            y = tf.nn.softmax(y, axis=-1)
        elif class_activation == "sigmoid":
            y = tf.math.sigmoid(y)
        return y

    return forward


def convert_to_tflite(
    variables: dict,
    cfg: ModelConfig,
    representative: np.ndarray | None = None,
    quantize: str = "int8",
    class_activation: str = "softmax",
    per_channel: bool = True,
) -> bytes:
    """Export Flax-layout variables to a TFLite flatbuffer.

    Args:
        variables: {params, batch_stats} in the Flax layouts
            (models/convert.py::state_dict_to_flax of a state_dict).
        cfg: Model config (defines the input shape and architecture).
        representative: [N, ...] calibration inputs (required for 'int8').
        quantize: 'int8' (full PTQ, float32 I/O — reference
            quantize.py:136-141), 'dynamic' (weights-only), or 'float'.
        per_channel: Per-channel weight quantization (opt-out mirrors the
            reference's --per_tensor flag, quantize.py:139-141).

    Returns:
        TFLite model bytes. Raises RuntimeError if I/O is not float32
        (reference quantize.py:154-163).
    """
    import tensorflow as tf

    if quantize not in ("int8", "dynamic", "float"):
        # An unknown mode must not silently export an unquantized,
        # ungated float model (the reference spelling 'ptq' maps to
        # 'int8' in cli/convert.py, not here).
        raise ValueError(f"quantize={quantize!r}: expected 'int8', "
                         "'dynamic', or 'float'")

    forward = build_tf_forward(variables, cfg, class_activation)
    spec = tf.TensorSpec((1, *cfg.input_shape()), tf.float32, name="input")
    concrete = tf.function(forward, input_signature=[spec]).get_concrete_function()
    converter = tf.lite.TFLiteConverter.from_concrete_functions([concrete])

    if quantize in ("int8", "dynamic"):
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    if quantize == "int8":
        if representative is None or len(representative) == 0:
            raise ValueError("int8 PTQ requires representative calibration inputs")

        def rep_gen():
            for sample in representative:
                yield [np.asarray(sample, np.float32)[None, ...]]

        converter.representative_dataset = rep_gen
        converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        converter.inference_input_type = tf.float32
        converter.inference_output_type = tf.float32
        converter.experimental_new_quantizer = True
        if not per_channel:
            converter._experimental_disable_per_channel = True  # noqa: SLF001

    tflite_bytes = converter.convert()

    interp = tf.lite.Interpreter(model_content=tflite_bytes)
    io_dtypes = {d["dtype"] for d in interp.get_input_details() + interp.get_output_details()}
    if io_dtypes != {np.float32}:
        raise RuntimeError(f"exported model I/O is not float32: {io_dtypes}")
    return tflite_bytes
