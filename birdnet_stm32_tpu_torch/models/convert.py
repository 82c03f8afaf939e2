"""Flax DSCNN variables -> the port's DSCNN state_dict.

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
