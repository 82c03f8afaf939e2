"""The benchmark's plain reference: what the timed path should produce,
worked out again from the inputs and weights the harness makes.

Nothing here imports the port (birdnet_stm32_tpu_torch), JAX or the JAX
package, and nothing takes a value the port made: the ingress and the
frontend are numpy in float64 (frontend.py), the float leg is each model
written out in plain torch float32 (dscnn.py for the DS-CNN), and the INT8
leg runs the raw .tflite file's integer graph op by op in numpy (int8.py,
read by tflite_file.py). It runs on the CPU, after the measured window, in
blocks of rows.

A configuration's `model` names its reference file, `<model>.py` here
(`model`). It defines
- `scores(sd, feats, config, cast)`: [B, classes] float32 scores of the
  model input `feats` under the weights `sd` (layer name -> float32 CPU
  tensor), with `cast` applied to every operand of each convolution and
  matmul (the identity, or the control's lower precision);
and may define
- `features(batch, config, mix)`: a request's batch as the traffic ships it
  -> the model's input (default: frontend.features);
- `seeded(name, shape, z, u, config)`: the seeded value of a parameter
  that gpubench/weights.py has no rule for, from the N(0, 1) and U(0, 1)
  draws `z` and `u` of its shape, or None.
"""

from __future__ import annotations

from pathlib import Path

from gpubench import load_file

DIR = Path(__file__).resolve().parent


def model(name: str):
    """The reference module of the model `name`: reference/<name>.py, which
    has to define `scores` (the helpers beside it, such as int8.py or
    frontend.py, are no model's reference)."""
    mod = load_file(DIR, name)
    if not callable(getattr(mod, "scores", None)):
        raise ValueError(f"model {name!r}: {DIR / f'{name}.py'} defines no scores()")
    return mod
