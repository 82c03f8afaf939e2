"""Flax DSCNN variables <-> the port's DSCNN state_dict.

Both models name their layers with the Keras names, so the map is a flat
rename plus the layout changes:

- conv kernel [kh, kw, in, out] -> weight [out, in, kh, kw]
  (a depthwise kernel [3, 3, 1, C] becomes [C, 1, 3, 3] by the same rule);
- the raw frontend's conv1d kernel audio_frontend/raw_fb [k, in, out] ->
  weight [out, in, k];
- dense kernel [in, out] -> weight [out, in];
- BN scale / bias / mean / var -> weight / bias / running_mean / running_var;
- everything else (audio_frontend/mel_mixer [F, M] or
  audio_frontend/mel_seg_logits [M+1], the per-channel
  audio_frontend/mag/pwl_* and pcen_* vectors, dense biases) is copied as
  it is.

state_dict_to_flax is the exact inverse (the TFLite export reads the Flax
layout), dropping the BN layers' num_batches_tracked.
"""

from __future__ import annotations

import numpy as np
import torch

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} nested dicts of numpy arrays (the
    tree models/dscnn.py::init_model returns in the JAX package) -> a
    state_dict for the port's DSCNN (load it with strict=True)."""
    out: dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})):
        a = np.array(value, dtype=np.float32)
        *module, leaf = path
        if leaf == "kernel":
            leaf = "weight"
            a = a.transpose({4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}[a.ndim])
        elif leaf == "scale":
            leaf = "weight"
            out[".".join((*module, "num_batches_tracked"))] = torch.tensor(0)
        out[".".join((*module, leaf))] = torch.from_numpy(np.ascontiguousarray(a))
    for path, value in _flatten(variables.get("batch_stats", {})):
        *module, leaf = path
        a = np.array(value, dtype=np.float32)
        out[".".join((*module, _BN_STATS[leaf]))] = torch.from_numpy(a)
    return out


_BN_STATS_INV = {v: k for k, v in _BN_STATS.items()}
_KERNEL_INV = {4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}


def _nest(tree: dict, path: list[str], value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def state_dict_to_flax(state_dict: dict) -> dict:
    """A state_dict of the port's DSCNN -> {'params': ..., 'batch_stats':
    ...} nested dicts of float32 numpy arrays in the Flax layouts (the
    inverse of flax_to_state_dict): a module with running statistics is a
    BN (weight -> scale, running_mean / running_var -> batch_stats mean /
    var), any other weight is a kernel ([out, in, kh, kw] -> [kh, kw, in,
    out], [out, in, k] -> [k, in, out], [out, in] -> [in, out])."""
    bn_modules = {k.rsplit(".", 1)[0] for k in state_dict if k.endswith(".running_mean")}
    out: dict = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *module, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = np.array(value.detach().cpu() if isinstance(value, torch.Tensor) else value,
                     dtype=np.float32)
        is_bn = ".".join(module) in bn_modules
        if leaf in _BN_STATS_INV:
            _nest(out["batch_stats"], [*module, _BN_STATS_INV[leaf]], a)
            continue
        if leaf == "weight":
            if is_bn:
                leaf = "scale"
            else:
                leaf = "kernel"
                a = np.ascontiguousarray(a.transpose(_KERNEL_INV[a.ndim]))
        _nest(out["params"], [*module, leaf], a)
    return out
