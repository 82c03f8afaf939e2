"""The mu-law companding encode (port of data/worker.py::ulaw_encode).

Only the encode is ported: the serving ingress (models/serving.py::
quantize_waveform_ulaw) needs it. numpy only, bit-equal to the JAX
package's.
"""

from __future__ import annotations

import numpy as np

_ULAW_MU = 255.0
_ULAW_LOG1P_MU = float(np.log1p(_ULAW_MU))
_ULAW_SCALE = np.float32(127.0 / _ULAW_LOG1P_MU)


def ulaw_encode(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float waveform -> int8 mu-law codes in [-127, 127]
    (mu = 255, the G.711 companding curve on a symmetric 8-bit grid).
    Inverse: models/serving._dequantize_ulaw (on the device); the round
    trip is off by at most half a companded step, ~2.2 % relative at every
    amplitude."""
    m = np.abs(x)
    np.minimum(m, np.float32(1.0), out=m)
    m *= np.float32(_ULAW_MU)
    np.log1p(m, out=m)
    m *= _ULAW_SCALE
    np.rint(m, out=m)
    return np.copysign(m, x).astype(np.int8)
