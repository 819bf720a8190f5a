"""Analytic solutions that the validation gates compare with (port of
gerris_tpu/utils/analytic.py:13-47).

The reference ships such solutions as tables (test/capwave/prosperetti);
here they are computed.  Host numpy and scipy: nothing here runs on the
device.
"""
from __future__ import annotations

import math

import numpy as np


def prosperetti_capwave(times, a0, k, nu, sigma, rho1=1.0, rho2=1.0):
    """Prosperetti's (1981) initial-value solution for the amplitude of a
    viscous capillary wave between two fluids of equal kinematic
    viscosity (Phys. Fluids 24:1217), the reference's capwave test's
    table test/capwave/prosperetti: the signed amplitude at each of
    ``times``, for the initial amplitude ``a0``, wavenumber ``k``,
    viscosity ``nu``, tension ``sigma`` and densities ``rho1``, ``rho2``."""
    from scipy.special import wofz

    times = np.asarray(times, dtype=float)
    rho = rho1 + rho2
    beta = rho1 * rho2 / (rho ** 2)
    omega0_sq = sigma * k ** 3 / rho
    eps = nu * k * k
    z = np.roots([1.0,
                  -4.0 * beta * math.sqrt(eps),
                  2.0 * (1.0 - 6.0 * beta) * eps,
                  4.0 * (1.0 - 3.0 * beta) * eps ** 1.5,
                  (1.0 - 4.0 * beta) * eps ** 2 + omega0_sq])
    out = np.zeros_like(times)
    for i, t in enumerate(times):
        s = 0.0 + 0.0j
        for j in range(4):
            zz = np.prod([z[m] - z[j] for m in range(4) if m != j])
            # exp((z^2 - eps) t) erfc(z sqrt(t)) = exp(-eps t) w(i z sqrt(t))
            s += (z[j] / zz) * (omega0_sq * a0) / (z[j] ** 2 - eps) * \
                np.exp(-eps * t) * wofz(1j * z[j] * math.sqrt(t))
        first = (4.0 * (1.0 - 4.0 * beta) * eps ** 2) / \
            (8.0 * (1.0 - 4.0 * beta) * eps ** 2 + omega0_sq) * a0 * \
            math.erfc(math.sqrt(eps * t))
        out[i] = first + s.real
    return out
