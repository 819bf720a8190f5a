"""Spectra and spectral initialization (port of gerris_tpu/spectral/fft.py).

Reference: modules/fft.c (GfsOutputSpectra, GfsOutputEnergySpectra
fft.h:54-121, the shell-binned write_spectra fft.c:1049) and
modules/turbulence.c (GfsInitSpectra, solenoidal_vel_field :626-900), on
torch.fft (the reference's FFTW, gerris_tpu's jnp.fft).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..core.device import default_device
from ..core.grid import Grid


def _fftfreq(n: int, device) -> torch.Tensor:
    """Integer wavenumbers of an n-point FFT, float64 (fftfreq(n) * n)."""
    return torch.fft.fftfreq(n, device=device, dtype=torch.float64) * n


def wavenumbers(grid: Grid, device=None) -> list:
    """Integer wavenumbers (units of 2 pi / L) in the rfftn layout, float64,
    each shaped to broadcast along its axis."""
    device = default_device(device)
    ks = []
    for a in range(grid.dim):
        n = grid.shape[a]
        k = torch.arange(n // 2 + 1, device=device, dtype=torch.float64) \
            if a == grid.dim - 1 else _fftfreq(n, device)
        sh = [1] * grid.dim
        sh[a] = k.shape[0]
        ks.append(k.reshape(sh))
    return ks


def energy_spectrum(U: list, grid: Grid):
    """The kinetic-energy spectrum E(k) summed over integer-|k| shells,
    normalized so that sum(E) is the mean kinetic energy (Parseval):
    (k_shells, E) (GfsOutputEnergySpectra, write_spectra fft.c:1049)."""
    dev = U[0].device
    shape = grid.shape
    ntot = math.prod(shape)
    ks = wavenumbers(grid, dev)
    kmag = torch.sqrt(sum(k ** 2 for k in ks))
    # the rfft layout holds each interior last-axis mode once for its
    # conjugate pair
    nlast = shape[-1] // 2 + 1
    last = torch.arange(nlast, device=dev)
    single = (last == 0) | ((shape[-1] % 2 == 0) & (last == nlast - 1))
    sh = [1] * grid.dim
    sh[-1] = nlast
    dbl = torch.where(single, 1.0, 2.0).to(U[0].dtype).reshape(sh)
    e = 0.0
    for u in U:
        uh = torch.fft.rfftn(u) / ntot
        e = e + 0.5 * (torch.abs(uh) ** 2) * dbl
    shells = torch.round(kmag).to(torch.int64)
    # the shells reach the k-space corners, so Parseval holds exactly
    kmax = int(math.ceil(math.sqrt(sum((s // 2) ** 2 for s in shape)))) + 2
    E = torch.zeros(kmax, dtype=e.dtype, device=dev)
    E.index_add_(0, shells.expand(e.shape).reshape(-1), e.reshape(-1))
    return torch.arange(kmax, device=dev), E


def scalar_spectrum(f: torch.Tensor, grid: Grid):
    """The shell power spectrum of a scalar (GfsOutputSpectra,
    fft.c:1101): sum(E) = mean(f^2)."""
    return energy_spectrum([f * math.sqrt(2.0)], grid)


def interface_spectrum(f: torch.Tensor, grid: Grid, axis: int = 1):
    """The power spectrum of a single-valued interface's height, the column
    sum of the fraction along ``axis`` less its mean: (k, |eta_hat|^2)
    with the conjugate pairs doubled (GfsOutputSpectraInterface, fft.h:
    54-121)."""
    eta = torch.sum(f, dim=axis) * grid.h + grid.origin[axis]
    eta = eta - torch.mean(eta)
    n = eta.shape[0]
    ek = torch.abs(torch.fft.rfft(eta) / n) ** 2
    k = torch.arange(ek.shape[0], device=f.device)
    single = (k == 0) | ((n % 2 == 0) & (k == ek.shape[0] - 1))
    return k, ek * torch.where(single, 1.0, 2.0).to(ek.dtype)


def init_solenoidal(grid: Grid, spectrum: Callable, generator=None,
                    noise=None, device=None, dtype=torch.float64) -> list:
    """A random divergence-free velocity with the shell energies
    ``spectrum(k)`` (a function of a float64 tensor of k), GfsInitSpectra's
    solenoidal_vel_field (turbulence.c:626-900): white noise per
    component, its FFT, the Nyquist planes zeroed, the Helmholtz
    projection u - k (k.u) / k^2, each shell rescaled to its target, the
    inverse FFT's real part.  The noise is ``noise`` (one field per
    component, e.g. the JAX package's jax.random.normal draws) or
    torch.randn from ``generator`` (the JAX function takes a key)."""
    device = default_device(device) if noise is None else noise[0].device
    shape = grid.shape
    dim = grid.dim
    ntot = math.prod(shape)
    if noise is None:
        noise = [torch.randn(shape, generator=generator, device=device,
                             dtype=dtype) for _ in range(dim)]
    uh = [torch.fft.fftn(torch.as_tensor(z)) for z in noise]
    ks = []
    for a in range(dim):
        sh = [1] * dim
        sh[a] = shape[a]
        ks.append(_fftfreq(shape[a], device).reshape(sh))
    # the +n/2 and -n/2 modes share an index: there the projection breaks
    # the Hermitian symmetry, so the Nyquist planes go first
    nyq = 0.0
    for a in range(dim):
        nyq = nyq + torch.where(torch.abs(ks[a]) == shape[a] // 2, 1.0, 0.0)
    uh = [torch.where(nyq > 0, 0.0, u) for u in uh]
    k2 = sum(k ** 2 for k in ks)
    k2s = torch.where(k2 == 0.0, 1.0, k2)
    kdotu = sum(ks[a] * uh[a] for a in range(dim))
    uh = [uh[a] - ks[a] * kdotu / k2s for a in range(dim)]
    shells = torch.round(torch.sqrt(k2)).to(torch.int64)
    kmax = int(max(shape)) // 2 + 1
    cur = 0.0
    for a in range(dim):
        cur = cur + 0.5 * torch.abs(uh[a] / ntot) ** 2
    sc = torch.clamp(shells, 0, kmax - 1)
    Ecur = torch.zeros(kmax, dtype=cur.dtype, device=device)
    Ecur.index_add_(0, sc.reshape(-1), cur.reshape(-1))
    ktab = torch.arange(kmax, dtype=torch.float64, device=device)
    Etgt = torch.where(ktab > 0, spectrum(ktab), 0.0).to(cur.dtype)
    scale = torch.sqrt(Etgt / torch.clamp(Ecur, min=torch.finfo(
        cur.dtype).tiny))[sc]
    scale = torch.where((shells <= 0) | (shells >= kmax), 0.0, scale)
    return [torch.fft.ifftn(uh[a] * scale).real for a in range(dim)]
