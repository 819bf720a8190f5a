"""The Kmax variable's curvature extension (gerris_tpu_torch physics/vof.py:
fill_curvature_weighted, the reference's diffuse_kmax) against
``gerris_tpu`` on the CPU in float64, and the first half of
tests/test_spurious.py::test_kmax_curvature_variable on the port (its
.gfs half, which reads the Kmax name through a parsed simulation, waits
for the port of utils/gfs_config.py).

Tolerance: 1e-12 of max|ref| at every cell, NaN exactly where the
reference has NaN."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.physics import vof as jvof  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.physics import vof as tvof  # noqa: E402


def _same(ref, got, bound=1e-12):
    ref, got = np.asarray(ref), got.numpy()
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got))
    scale = np.max(np.abs(ref[~nan]))
    assert np.max(np.abs(ref[~nan] - got[~nan])) <= bound * scale


@pytest.mark.parametrize("shape", [(40, 56), (12, 16, 20)])
@pytest.mark.parametrize("niter", [1, 2, 4])
def test_fill_curvature_weighted_matches_jax(shape, niter):
    """Random curvatures with NaN gaps and fractions with full, empty and
    band cells (f(1-f) on both sides of the threshold), 2D and 3D."""
    rng = np.random.default_rng(len(shape) * 10 + niter)
    kap = rng.uniform(-5.0, 5.0, shape)
    kap[rng.uniform(size=shape) < 0.4] = np.nan
    T = rng.uniform(0.0, 1.0, shape)
    T[rng.uniform(size=shape) < 0.3] = 0.0
    T[rng.uniform(size=shape) < 0.2] = 1.0
    T[rng.uniform(size=shape) < 0.1] = 0.005
    for fmin in (0.01, 0.1):
        ref = jvof.fill_curvature_weighted(jnp.asarray(kap), jnp.asarray(T),
                                           niter=niter, fmin=fmin)
        got = tvof.fill_curvature_weighted(torch.from_numpy(kap),
                                           torch.from_numpy(T), niter=niter,
                                           fmin=fmin)
        _same(ref, got)


def test_kmax_curvature_variable():
    """|kappa| of a circle of radius 0.25 at level 6 extended by two
    f(1-f)-weighted passes: within 15% of 1/R on every defined cell of the
    band |r - R| < 2h."""
    grid = TGrid(level=6)
    Rd = 0.25
    T = tvof.fraction_from_levelset(
        grid, lambda x, y: Rd * Rd - (x ** 2 + y ** 2), device="cpu")
    kap = tvof.curvature(T, grid, tbc.default_scalar_bc(2))
    kmax = tvof.fill_curvature_weighted(kap.abs(), T, niter=2)
    x, y = [torch.as_tensor(c) for c in grid.centers]
    band = ((x ** 2 + y ** 2).sqrt() - Rd).abs() < 2 * grid.h
    vals = kmax[band]
    vals = vals[torch.isfinite(vals)]
    assert vals.numel() > 0
    assert float((vals - 1.0 / Rd).abs().max()) / (1.0 / Rd) < 0.15
