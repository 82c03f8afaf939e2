"""Runs torch's CPU kernels once per process before the port's parity tests,
and checks them afterwards.

On an x86-64 virtual machine with AVX-512 and AMX, the first call of some
vectorized torch CPU kernels in a process (sqrt, log10 and exp, after a
matrix product) returned one thread's chunk of the result off by up to
3e-4 relative, in about 1 % of fresh processes; every later call was
exact. Measured with 420 fresh processes each: 4 faulty first calls
without this warm-up, none with it. The port's tests compare with the JAX
package at 1e-5, so each of their modules calls `warm_up()` when it is
imported, and those first calls land on throwaway data.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

_done = False


def warm_up() -> None:
    """Calls each CPU kernel the port's tests reach once (only the first
    call in a process does anything)."""
    global _done
    if _done:
        return
    _done = True
    g = torch.Generator().manual_seed(0)
    x = torch.rand(8, 256, 258, generator=g)
    y = x @ torch.rand(258, 256, generator=g)
    for f in (torch.sqrt, torch.log10, torch.exp, torch.log, torch.log1p, torch.expm1,
              torch.square, torch.relu, torch.sigmoid):
        f(y)
    torch.hypot(y, y)
    y.pow(0.5)
    torch.softmax(y, dim=-1)
    y.amin(dim=(1, 2))
    y.amax(dim=(1, 2))
    img = y[:, None]
    F.conv2d(img, torch.rand(4, 1, 3, 3, generator=g), padding=1)
    F.conv2d(img.expand(-1, 4, -1, -1), torch.rand(4, 1, 3, 3, generator=g), groups=4)
    F.batch_norm(img, torch.zeros(1), torch.ones(1), training=False)
    F.hardtanh(img, 0.0, 6.0)


@pytest.mark.parametrize("name", ["sqrt", "log10", "exp", "log1p", "expm1"])
def test_cpu_kernels_exact_after_warm_up(name):
    """After warm_up, the CPU kernels the port's plain versions use agree
    with float64 numpy to float32 rounding, on every thread's chunk."""
    warm_up()
    g = torch.Generator().manual_seed(1)
    x = 0.5 + (torch.rand(8, 33, 250, generator=g) @ torch.rand(250, 258, generator=g))
    torch_fn, np_fn = {"sqrt": (torch.sqrt, np.sqrt), "log10": (torch.log10, np.log10),
                       "exp": (lambda v: torch.exp(-v), lambda v: np.exp(-v)),
                       "log1p": (torch.log1p, np.log1p),
                       "expm1": (lambda v: torch.expm1(0.01 * v),
                                 lambda v: np.expm1(0.01 * v))}[name]
    ref = np_fn(x.numpy().astype(np.float64))
    np.testing.assert_allclose(torch_fn(x).numpy(), ref, rtol=1e-6, atol=0)
