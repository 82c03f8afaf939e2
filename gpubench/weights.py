"""Seeded float32 weights for a configuration whose runner is "torch",
made on the device from --seed in two large calls.

The harness makes them, hands the same values to the program (which casts
its own copy to the precision the configuration states) and, after the
window, a CPU copy to the plain reference. Rules by layer name:
convolution kernels He-normal, the dense head LeCun-normal with a bias of
N(0, 0.1), BN scale U(0.8, 1.2), shift N(0, 0.05), running mean N(0,
0.05), running variance U(0.8, 1.2); the hybrid mel mixer is the Slaney
bank and the pwl curve keeps its published defaults (k0 0.40, thresholds
0.10 / 0.35 / 0.65, slopes 0.25 / 0.15 / 0.08). A parameter that no rule
covers is given by the `seeded` function of the configuration's reference
module (gpubench/reference/<model>.py), from the same draws; without one,
or where it returns None, seeding refuses the model.
"""

from __future__ import annotations

import math

import torch

from gpubench import reference
from gpubench.reference.mel import mel_filterbank

PWL_K0 = 0.40
PWL_THRESHOLDS = (0.10, 0.35, 0.65)
PWL_SLOPES = (0.25, 0.15, 0.08)


def _fixed(name: str, shape, model: dict) -> torch.Tensor | None:
    if name == "audio_frontend.mel_mixer":
        sr = model["sample_rate"]
        return torch.from_numpy(mel_filterbank(sr, model["fft_length"], model["num_mels"],
                                               fmin=150.0, fmax=float(sr // 2)))
    tail = name.rsplit(".", 1)[-1]
    if tail == "pwl_k0":
        return torch.full(shape, PWL_K0)
    for i, (t, k) in enumerate(zip(PWL_THRESHOLDS, PWL_SLOPES), start=1):
        value = {f"pwl_shift{i}_w": 1.0, f"pwl_shift{i}_b": -t, f"pwl_k{i}": k}.get(tail)
        if value is not None:
            return torch.full(shape, value)
    return None


@torch.no_grad()
def seeded_state(template: dict, model: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for every floating entry of
    `template` (a state_dict's names and tensors, whose shapes are used)."""
    shapes = {k: tuple(v.shape) for k, v in template.items() if v.is_floating_point()}
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at, by_model = {}, 0, None
    for name, shape in shapes.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        fixed = _fixed(name, shape, model)
        tail = name.rsplit(".", 1)[-1]
        is_bn = "_bn." in name
        if fixed is not None:
            out[name] = fixed.to(device)
        elif is_bn and tail == "weight":
            out[name] = 0.8 + 0.4 * u
        elif is_bn and tail in ("bias", "running_mean"):
            out[name] = 0.05 * z
        elif is_bn and tail == "running_var":
            out[name] = 0.8 + 0.4 * u
        elif tail == "weight" and len(shape) == 4:
            out[name] = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif tail == "weight" and len(shape) == 2:
            out[name] = z * math.sqrt(1.0 / shape[1])
        elif tail == "bias":
            out[name] = 0.1 * z
        else:
            if by_model is None:
                by_model = getattr(reference.model(model["model"]), "seeded",
                                     lambda *a: None)
            value = by_model(name, shape, z, u, model)
            if value is None:
                raise ValueError(f"no seeding rule for {name} {shape}")
            out[name] = torch.as_tensor(value, dtype=torch.float32, device=device)
    return out
