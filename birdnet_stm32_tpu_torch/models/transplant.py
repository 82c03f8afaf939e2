"""Reference .keras archive -> the port's DSCNN (port of models/transplant.py).

Reads a Keras 3 archive (a zip of config.json and model.weights.h5) without
TensorFlow and maps its weights onto the port's DSCNN.

Two naming worlds meet here:
- config.json holds the functional graph with the builder's layer names
  (stem_conv, stage1_ds1_dw, ...), which are the port's module names too;
- model.weights.h5 groups layers by snake_case(class name) with a
  per-class counter in graph order (Keras 3 saving_lib), e.g. the second
  BatchNormalization anywhere in the model is `layers/batch_normalization_1`.

The archive is read into the JAX package's Flax-layout tree of numpy
arrays ({params, batch_stats}, the tree its transplant yields before its
jnp.asarray), and that tree goes through models/convert.py::
flax_to_state_dict, the one place that knows torch's layouts. h5py is
imported inside the functions that read the archive.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig


def _snake_case(name: str) -> str:
    """Keras' class-name -> default-name conversion (Conv2D -> conv2d)."""
    s = re.sub(r"(.)([A-Z][a-z0-9]+)", r"\1_\2", name)
    s = re.sub(r"([a-z])([A-Z])", r"\1_\2", s)
    return s.lower().replace("__", "_")


def read_keras_archive(path: str | Path):
    """(functional graph config, open weights h5) of a .keras zip."""
    import h5py

    with zipfile.ZipFile(path) as z:
        graph = json.loads(z.read("config.json"))
        weights = z.read("model.weights.h5")
    return graph, h5py.File(io.BytesIO(weights), "r")


def layer_h5_names(layers: list[dict]) -> dict[str, str]:
    """Graph layer name -> h5 group name under `layers/`."""
    counters: dict[str, int] = {}
    mapping: dict[str, str] = {}
    for layer in layers:
        slug = _snake_case(layer["class_name"])
        n = counters.get(slug, 0)
        counters[slug] = n + 1
        mapping[layer["name"]] = slug if n == 0 else f"{slug}_{n}"
    return mapping


def detect_arch(layers: list[dict]) -> dict[str, Any]:
    """Architecture toggles from the graph's layer names and classes.

    The sidecar config may predate fields like use_se, so the graph decides.
    Only the builder's exact block-name patterns count: a layer whose name
    merely contains '_se' or '_ir1' (e.g. 'probe_sep') toggles nothing.
    """
    names = [layer["name"] for layer in layers]

    def has(pat: str) -> bool:
        return any(re.search(pat, n) for n in names)

    out: dict[str, Any] = {
        # stage{i}_ir{b}_<sublayer>; stage{i}_se{b}_<squeeze|reduce|expand|scale>
        # (plain DS + SE); stage{i}_ir{b}_se_<...> (IR + SE).
        "use_inverted_residual": has(r"^stage\d+_ir\d+_"),
        "use_se": has(r"^stage\d+_(ir\d+_)?se\d*_(squeeze|reduce|expand|scale)$"),
        "use_attention_pooling": any(layer["class_name"] == "AttentionPooling"
                                     for layer in layers),
    }
    for layer in layers:
        if layer["class_name"] == "Dense" and layer["name"] == "pred":
            out["class_activation"] = layer["config"].get("activation", "softmax")
    return out


def _vars(h5, group: str) -> list[np.ndarray]:
    g = h5["layers"][group]["vars"]
    return [np.asarray(g[str(i)]) for i in range(len(g.keys()))]


def _frontend_params(h5, group: str, mag_scale: str, fft_bins: int) -> dict:
    """The AudioFrontendLayer's weights, keyed by nested attribute paths."""
    g = h5["layers"][group]
    out: dict[str, Any] = {}
    mag: dict[str, Any] = {}

    def get(path: str):
        node = g
        for part in path.split("/"):
            if part not in node:
                return None
            node = node[part]
        return node

    # Hybrid mel mixer [1, 1, cin_padded, M] -> [fft_bins, M]: strip the
    # zero input-channel padding. An unbuilt mixer (non-hybrid modes) still
    # saves an empty vars group, so the weight entry itself must exist.
    mixer = get("mel_mixer/vars")
    if mixer is not None and "0" in mixer:
        out["mel_mixer"] = np.asarray(mixer["0"])[0, 0, :fft_bins, :]

    # Raw filterbank: Conv2D [1, k_t, 1, M] -> 1-D conv [k_t, 1, M].
    for cand in ("fb2d/vars", "audio_frontend_raw_fb2d/vars"):
        fb = get(cand)
        if fb is not None:
            out["raw_fb"] = {"kernel": np.asarray(fb["0"])[0]}
            break
    fb_bn = get("fb_bn/vars")
    if fb_bn is not None:
        v = [np.asarray(fb_bn[str(i)]) for i in range(4)]
        out["raw_fb_bn"] = {"scale": v[0], "bias": v[1]}
        out["_raw_fb_bn_stats"] = {"mean": v[2], "var": v[3]}

    def dw_vec(path: str):
        node = get(path)
        return None if node is None else np.asarray(node["0"]).reshape(-1)

    def dw_bias(path: str):
        node = get(path)
        if node is None or "1" not in node:
            return None
        return np.asarray(node["1"]).reshape(-1)

    def require(key: str, value, what: str):
        # Once one sublayer resolved under a prefix its siblings must exist.
        if value is None:
            raise KeyError(
                f"checkpoint frontend is missing the '{what}' weights expected for "
                f"mag_scale={mag_scale!r} (found its siblings under the same prefix: "
                "renamed or partially saved layer?)")
        mag[key] = value

    if mag_scale == "pwl":
        # Older checkpoints keep the pwl weights on the frontend itself;
        # newer ones nest them under the mag layer.
        for prefix in ("", "mag_layer/"):
            k0 = dw_vec(f"{prefix}_pwl_k0_dw/vars")
            if k0 is None:
                continue
            mag["pwl_k0"] = k0
            for i, sub in enumerate(["depthwise_conv2d", "depthwise_conv2d_1",
                                     "depthwise_conv2d_2"], start=1):
                require(f"pwl_k{i}", dw_vec(f"{prefix}_pwl_k_dws/{sub}/vars"),
                        f"_pwl_k_dws/{sub}")
                require(f"pwl_shift{i}_w", dw_vec(f"{prefix}_pwl_shift_dws/{sub}/vars"),
                        f"_pwl_shift_dws/{sub} kernel")
                require(f"pwl_shift{i}_b", dw_bias(f"{prefix}_pwl_shift_dws/{sub}/vars"),
                        f"_pwl_shift_dws/{sub} bias")
            break
    elif mag_scale == "pcen":
        for prefix in ("", "mag_layer/"):
            agc = dw_vec(f"{prefix}_pcen_agc_dw/vars")
            if agc is None:
                continue
            mag["pcen_agc"] = agc
            require("pcen_k1", dw_vec(f"{prefix}_pcen_k1_dw/vars"), "_pcen_k1_dw")
            require("pcen_shift_w", dw_vec(f"{prefix}_pcen_shift_dw/vars"),
                    "_pcen_shift_dw kernel")
            require("pcen_shift_b", dw_bias(f"{prefix}_pcen_shift_dw/vars"),
                    "_pcen_shift_dw bias")
            require("pcen_k2mk1", dw_vec(f"{prefix}_pcen_k2mk1_dw/vars"), "_pcen_k2mk1_dw")
            break

    if mag:
        out["mag"] = mag
    return out


def transplant_variables(keras_path: str | Path, cfg: ModelConfig) -> tuple[dict, dict[str, Any]]:
    """({params, batch_stats} as nested dicts of float32 numpy arrays in the
    Flax layout, detected-architecture overrides) of a .keras archive.

    cfg supplies the frontend fields (mag_scale, fft_bins); the
    architecture toggles come from the graph (detect_arch).
    """
    graph, h5 = read_keras_archive(keras_path)
    try:
        layers = graph["config"]["layers"]
        name_map = layer_h5_names(layers)
        arch = detect_arch(layers)
        params: dict[str, Any] = {}
        stats: dict[str, Any] = {}
        for layer in layers:
            cls, name = layer["class_name"], layer["name"]
            group = name_map[name]
            if cls in ("Conv2D", "Dense"):
                v = _vars(h5, group)
                params[name] = {"kernel": v[0], **({"bias": v[1]} if len(v) > 1 else {})}
            elif cls == "DepthwiseConv2D":
                (k,) = _vars(h5, group)
                if k.shape[3] != 1:
                    # The transpose below holds for depth_multiplier 1 only.
                    raise NotImplementedError(
                        f"DepthwiseConv2D '{name}' has depth_multiplier={k.shape[3]}; "
                        "transplant supports multiplier 1 only (the reference builder "
                        "never emits more)")
                params[name] = {"kernel": np.transpose(k, (0, 1, 3, 2))}  # [kh,kw,C,1]->[kh,kw,1,C]
            elif cls == "BatchNormalization":
                gamma, beta, mean, var = _vars(h5, group)
                params[name] = {"scale": gamma, "bias": beta}
                stats[name] = {"mean": mean, "var": var}
            elif cls == "AudioFrontendLayer":
                fe = _frontend_params(h5, group, cfg.mag_scale, cfg.fft_bins)
                bn_stats = fe.pop("_raw_fb_bn_stats", None)
                params["audio_frontend"] = fe
                if bn_stats is not None:
                    stats["audio_frontend"] = {"raw_fb_bn": bn_stats}
            elif cls == "AttentionPooling":
                g = h5["layers"][group]
                # Keras 3 keys nested layers by attribute name: the
                # reference keeps Dense(1, name="score") in self._score_dense.
                for key in ("_score_dense", "score"):
                    if key in g and "vars" in g[key] and "0" in g[key]["vars"]:
                        params["attn_pool_score"] = {"kernel": np.asarray(g[key]["vars"]["0"])}
                        break
    finally:
        h5.close()

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
                for k, v in tree.items()}

    variables = {"params": f32(params)}
    if stats:
        variables["batch_stats"] = f32(stats)
    return variables, arch


def transplant_params(keras_path: str | Path, cfg: ModelConfig) -> tuple[dict, dict[str, Any]]:
    """(state_dict for the port's DSCNN, detected-architecture overrides)
    of a .keras archive."""
    from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict

    variables, arch = transplant_variables(keras_path, cfg)
    return flax_to_state_dict(variables), arch


def load_reference_model(keras_path: str | Path, config_path: str | Path,
                         device: str | torch.device = "cuda"):
    """(model, state_dict, cfg) of a .keras archive and its sidecar config:
    a DSCNN in eval mode on `device` (default CUDA; raises if there is
    none) with the weights loaded. The head is the graph's
    `class_activation`; the architecture toggles are the graph's too."""
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

    cfg = ModelConfig.load(config_path)
    state_dict, arch = transplant_params(keras_path, cfg)
    activation = arch.pop("class_activation", "softmax")
    cfg = dataclasses.replace(cfg, **arch)
    model = build_dscnn(cfg, class_activation=activation, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model, state_dict, cfg
