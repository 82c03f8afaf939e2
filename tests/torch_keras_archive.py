"""Writes Keras-3-layout .keras archives from a Flax-layout variable tree
(no JAX, no TensorFlow; h5py and numpy).

The archive is what the reference's Keras 3 saving writes for a DS-CNN
built by its builder: `config.json` with the functional graph's layers in
the builder's order (class names and the builder's layer names), and
`model.weights.h5` with one group per layer under `layers/`, named by
snake_case(class name) and a per-class counter in graph order, holding
the weights in Keras layouts:

- Conv2D [kh, kw, in, out] (+ bias), Dense [in, out] (+ bias): as Flax;
- DepthwiseConv2D [kh, kw, C, 1] (Flax [kh, kw, 1, C]);
- BatchNormalization gamma, beta, moving mean, moving variance;
- the AudioFrontendLayer's sublayers as nested attribute groups:
  mel_mixer [1, 1, cin_padded, M] (zero input-channel padding),
  fb2d [1, k, 1, M] and fb_bn (raw), the per-channel pwl / pcen
  DepthwiseConv2D kernels [1, 1, C, 1] (and biases) under
  `<prefix>_pwl_*` / `<prefix>_pcen_*`, with `prefix` "" (older
  checkpoints) or "mag_layer/" (newer);
- AttentionPooling's score Dense under its attribute `_score_dense`.

Weightless layers (InputLayer, ReLU, Dropout, ...) get an empty `vars`
group, as Keras 3 writes them.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from pathlib import Path

import numpy as np

_SUB_ORDER = ["expand", "expand_bn", "dw", "dw_bn", "se_reduce", "se_expand",
              "pw", "pw_bn", "project", "project_bn"]


def _snake_case(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z0-9]+)", r"\1_\2", name)
    s = re.sub(r"([a-z])([A-Z])", r"\1_\2", s)
    return s.lower().replace("__", "_")


def _build_rank(name: str):
    """The builder's order: frontend, stem, stages and blocks in order
    (each block's sublayers in call order, a plain block's SE after it),
    emb, attention pooling, pred."""
    if name == "audio_frontend":
        return (0,)
    if name.startswith("stem_"):
        return (1, name != "stem_conv")
    m = re.match(r"^stage(\d+)_(ds|ir|se)(\d+)_(.*)$", name)
    if m:
        stage, kind, block, sub = int(m[1]), m[2], int(m[3]), m[4]
        if kind == "se":  # plain DS + SE: after the block's pw_bn
            return (2, stage, block, 1, ["reduce", "expand"].index(sub))
        return (2, stage, block, 0, _SUB_ORDER.index(sub))
    return (3, ["emb_conv", "emb_bn", "attn_pool_score", "pred"].index(name))


def _layer_class(name: str, entry: dict) -> str:
    if name == "audio_frontend":
        return "AudioFrontendLayer"
    if name == "attn_pool_score":
        return "AttentionPooling"
    if "scale" in entry:
        return "BatchNormalization"
    k = entry["kernel"]
    if k.ndim == 2:
        return "Dense"
    return "DepthwiseConv2D" if name.endswith("_dw") else "Conv2D"


def _put_vars(group, arrays) -> None:
    v = group.create_group("vars")
    for i, a in enumerate(arrays):
        v.create_dataset(str(i), data=np.asarray(a, np.float32))


def _dw(v: np.ndarray) -> np.ndarray:
    return np.asarray(v, np.float32).reshape(1, 1, -1, 1)


def _write_frontend(g, fe: dict, fe_stats: dict, mag_prefix: str) -> None:
    if "mel_mixer" in fe:
        mixer = np.asarray(fe["mel_mixer"], np.float32)
        pad = (-mixer.shape[0]) % 8 or 8
        padded = np.concatenate([mixer, np.zeros((pad, mixer.shape[1]), np.float32)])
        _put_vars(g.create_group("mel_mixer"), [padded[None, None]])
    else:
        g.create_group("mel_mixer").create_group("vars")  # built lazily: empty
    if "raw_fb" in fe:
        _put_vars(g.create_group("fb2d"), [np.asarray(fe["raw_fb"]["kernel"])[None]])
        bn, st = fe["raw_fb_bn"], fe_stats["raw_fb_bn"]
        _put_vars(g.create_group("fb_bn"), [bn["scale"], bn["bias"], st["mean"], st["var"]])
    mag = fe.get("mag", {})
    root = g.create_group(mag_prefix.rstrip("/")) if mag_prefix else g
    subs = ["depthwise_conv2d", "depthwise_conv2d_1", "depthwise_conv2d_2"]
    if "pwl_k0" in mag:
        _put_vars(root.create_group("_pwl_k0_dw"), [_dw(mag["pwl_k0"])])
        ks, shifts = root.create_group("_pwl_k_dws"), root.create_group("_pwl_shift_dws")
        for i, sub in enumerate(subs, start=1):
            _put_vars(ks.create_group(sub), [_dw(mag[f"pwl_k{i}"])])
            _put_vars(shifts.create_group(sub), [_dw(mag[f"pwl_shift{i}_w"]),
                                                 mag[f"pwl_shift{i}_b"]])
    if "pcen_agc" in mag:
        _put_vars(root.create_group("_pcen_agc_dw"), [_dw(mag["pcen_agc"])])
        _put_vars(root.create_group("_pcen_k1_dw"), [_dw(mag["pcen_k1"])])
        _put_vars(root.create_group("_pcen_shift_dw"), [_dw(mag["pcen_shift_w"]),
                                                        mag["pcen_shift_b"]])
        _put_vars(root.create_group("_pcen_k2mk1_dw"), [_dw(mag["pcen_k2mk1"])])


def write_keras_archive(path, variables: dict, class_activation: str = "softmax",
                        mag_prefix: str = "") -> Path:
    """Write `variables` ({params, batch_stats} nested dicts of arrays in
    the Flax layout) as a reference-style .keras archive at `path`."""
    import h5py

    params = variables["params"]
    stats = variables.get("batch_stats", {})
    layers = [{"class_name": "InputLayer", "name": "input_layer", "config": {}}]
    # The reference graph always holds the frontend layer, weights or not.
    for name in sorted({*params, "audio_frontend"}, key=_build_rank):
        cls = _layer_class(name, params.get(name, {}))
        graph_name = "attn_pool" if cls == "AttentionPooling" else name
        config = {"activation": class_activation} if name == "pred" else {}
        layers.append({"class_name": cls, "name": graph_name, "config": config})
        if name.endswith("_bn"):
            layers.append({"class_name": "ReLU", "name": f"{name}_relu", "config": {}})
    layers.append({"class_name": "Dropout", "name": "dropout", "config": {}})
    layers.sort(key=lambda l: l["name"] == "pred")  # pred last; stable otherwise

    buf = io.BytesIO()
    counters: dict[str, int] = {}
    with h5py.File(buf, "w") as h5:
        root = h5.create_group("layers")
        for layer in layers:
            slug = _snake_case(layer["class_name"])
            n = counters.get(slug, 0)
            counters[slug] = n + 1
            g = root.create_group(slug if n == 0 else f"{slug}_{n}")
            cls, name = layer["class_name"], layer["name"]
            if cls == "AudioFrontendLayer":
                g.create_group("vars")
                _write_frontend(g, params.get(name, {}), stats.get(name, {}), mag_prefix)
            elif cls == "AttentionPooling":
                g.create_group("vars")
                _put_vars(g.create_group("_score_dense"), [params["attn_pool_score"]["kernel"]])
            elif cls == "BatchNormalization":
                p, s = params[name], stats[name]
                _put_vars(g, [p["scale"], p["bias"], s["mean"], s["var"]])
            elif cls == "DepthwiseConv2D":
                _put_vars(g, [np.transpose(np.asarray(params[name]["kernel"]), (0, 1, 3, 2))])
            elif cls in ("Conv2D", "Dense"):
                e = params[name]
                _put_vars(g, [e["kernel"], *([e["bias"]] if "bias" in e else [])])
            else:
                g.create_group("vars")
    graph = {"class_name": "Functional", "config": {"name": "birdnet_dscnn", "layers": layers}}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr("metadata.json", json.dumps({"keras_version": "3.13.0"}))
        z.writestr("config.json", json.dumps(graph))
        z.writestr("model.weights.h5", buf.getvalue())
    return path
