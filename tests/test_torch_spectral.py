"""Spectra and spectral initialization (gerris_tpu_torch/spectral/fft.py)
against the JAX package on the CPU in float64, and the gates of
tests/test_spectral.py on the port.

The wavenumbers, the energy spectrum (square, box and 3D grids, odd and
even sides), the scalar and interface spectra within 1e-12 of max, and
init_solenoidal fed the JAX key's own noise (jax.random.normal of the
split keys) within 1e-12."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.spectral import fft as jspec  # noqa: E402

from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import vof  # noqa: E402
from gerris_tpu_torch.spectral import fft as spec  # noqa: E402

CPU = torch.device("cpu")


def close(a, b, rtol=1e-12):
    a = np.asarray(a, dtype=np.float64)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
    assert err <= rtol, err


GRIDS = [dict(level=5), dict(level=4, extents=(1, 2)),
         dict(level=3, dim=3)]


def pair(kw):
    return JGrid(**kw), Grid(**kw)


@pytest.mark.parametrize("kw", GRIDS, ids=["32", "16x32", "8^3"])
def test_wavenumbers_and_energy_spectrum_match_jax(kw):
    jg, tg = pair(kw)
    for a, b in zip(jspec.wavenumbers(jg), spec.wavenumbers(tg, CPU)):
        close(np.broadcast_to(np.asarray(a, float), b.shape), b, 0.0)
    rng = np.random.default_rng(0)
    U = [rng.standard_normal(tg.shape) for _ in range(tg.dim)]
    jk, jE = jspec.energy_spectrum([jnp.asarray(u) for u in U], jg)
    tk, tE = spec.energy_spectrum([torch.as_tensor(u) for u in U], tg)
    close(jk, tk, 0.0)
    close(jE, tE)
    jk, jE = jspec.scalar_spectrum(jnp.asarray(U[0]), jg)
    tk, tE = spec.scalar_spectrum(torch.as_tensor(U[0]), tg)
    close(jE, tE)


def test_interface_spectrum_matches_jax():
    rng = np.random.default_rng(1)
    f = np.clip(rng.uniform(-0.5, 1.5, (32, 32)), 0.0, 1.0)
    for axis in (0, 1):
        jk, jE = jspec.interface_spectrum(jnp.asarray(f), JGrid(5), axis)
        tk, tE = spec.interface_spectrum(torch.as_tensor(f), Grid(5), axis)
        close(jk, tk, 0.0)
        close(jE, tE)


def _jax_noise(key, shape, dim):
    """The white noise init_solenoidal draws from ``key``."""
    keys = jax.random.split(key, dim)
    return [np.asarray(jax.random.normal(keys[c], shape))
            for c in range(dim)]


@pytest.mark.parametrize("kw", GRIDS[:1] + GRIDS[2:], ids=["32", "8^3"])
def test_init_solenoidal_matches_jax(kw):
    """init_solenoidal fed the JAX key's noise gives the JAX field."""
    jg, tg = pair(kw)
    key = jax.random.PRNGKey(3)
    jU = jspec.init_solenoidal(
        jg, lambda k: jnp.where(k >= 2, k ** (-5.0 / 3.0), 0.0), key)
    tU = spec.init_solenoidal(
        tg, lambda k: torch.where(k >= 2, k ** (-5.0 / 3.0), 0.0),
        noise=[torch.as_tensor(z) for z in _jax_noise(key, tg.shape,
                                                      tg.dim)])
    for a, b in zip(jU, tU):
        close(a, b)


# -- the gates of tests/test_spectral.py on the port -------------------------

def test_energy_spectrum_single_mode():
    """A single Fourier mode lands in its shell with Parseval's energy."""
    grid = Grid(6)
    x, _ = (torch.as_tensor(c) for c in grid.centers)
    U = [torch.sin(2 * math.pi * 5 * x), torch.zeros(grid.shape,
                                                     dtype=torch.float64)]
    k, E = spec.energy_spectrum(U, grid)
    assert int(torch.argmax(E)) == 5
    assert abs(float(E.sum()) - float((0.5 * U[0] ** 2).mean())) < 1e-12
    assert float(E[5]) / float(E.sum()) > 0.999


def test_init_solenoidal():
    """Divergence-free in k-space, with the prescribed shell energies
    (turbulence.c:626-900); the noise from a seeded torch.Generator."""
    grid = Grid(6)

    def target(k):
        return torch.where((k >= 3) & (k <= 20), k ** (-5.0 / 3.0), 0.0)
    U = spec.init_solenoidal(grid, target, device=CPU,
                             generator=torch.Generator().manual_seed(0))
    ks = []
    for a in range(2):
        kk = torch.fft.fftfreq(grid.shape[a], dtype=torch.float64) * \
            grid.shape[a]
        ks.append(kk.reshape([-1, 1] if a == 0 else [1, -1]))
    div = sum(ks[a] * torch.fft.fftn(U[a]) for a in range(2))
    assert float(div.abs().max() / torch.fft.fftn(U[0]).abs().max()) < 1e-10
    _, E = spec.energy_spectrum(U, grid)
    for kk in (4, 8, 16):
        tgt = kk ** (-5.0 / 3.0)
        assert abs(float(E[kk]) - tgt) / tgt < 1e-6, kk


def test_scalar_spectrum_parseval():
    f = torch.randn((32, 32), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    _, E = spec.scalar_spectrum(f, Grid(5))
    assert abs(float(E.sum()) - float((f ** 2).mean())) < 1e-10


def test_interface_spectrum():
    """A single-mode interface: one peak with the mode's amplitude a0^2 / 2
    (the fraction carries ~2% amplitude error at 64^2), the JAX
    package's fraction and spectrum alike."""
    grid = Grid(6)
    a0, kmode = 0.03, 3
    f = vof.fraction_from_levelset(
        grid, lambda x, y: a0 * torch.cos(2 * math.pi * kmode * x) - y,
        device=CPU)
    _, E = spec.interface_spectrum(f, grid, axis=1)
    assert int(torch.argmax(E[1:])) + 1 == kmode
    assert abs(float(E[kmode]) - a0 * a0 / 2) / (a0 * a0 / 2) < 0.05
    jf = jvof.fraction_from_levelset(
        JGrid(6), lambda x, y: a0 * jnp.cos(2 * math.pi * kmode * x) - y)
    close(jspec.interface_spectrum(jf, JGrid(6), axis=1)[1], E)
