"""mac_projection with a cell divergence source on the port against the JAX
package on the CPU in float64, with and without an embedded solid, under
an all-Neumann pressure (the mean of div + div_source removed, weighted by
the fluid volume with a solid) and under one Dirichlet side (no mean
removed).

The port follows the JAX package's generic route, the one it takes on the
CPU: the mean removed is that of the divergence with the source added.
On a TPU in float32 without a solid the JAX package takes K4's route
instead, which subtracts K4's total alone and leaves the source's mean in
the right-hand side.

16^2 cells, seeded face velocities and a source with a nonzero mean, dt
0.1, 20 cycles to 1e-10: the faces, the cell gradients and P (mean-free
under the all-Neumann pressure) within 1e-10 of max."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import solid as jsolid  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402
from gerris_tpu.solvers import projection as jproj  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import solid  # noqa: E402
from gerris_tpu_torch.solvers import poisson  # noqa: E402
from gerris_tpu_torch.solvers import projection as tproj  # noqa: E402

RTOL = 1e-10
LEVEL = 4
DT = 0.1


def _jphi(x, y):
    return jnp.sqrt(x * x + y * y) - 0.2


def _tphi(x, y):
    return torch.sqrt(x * x + y * y) - 0.2


def _pbc(mod, dirichlet):
    nn = (mod.Neumann(), mod.Neumann())
    x = (mod.Neumann(), mod.Dirichlet(0.0)) if dirichlet else nn
    return mod.FieldBC((x, nn))


def _rel(ref, got, mean_free=False):
    a, b = np.asarray(ref), got.numpy()
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


@pytest.mark.parametrize("with_solid", [False, True])
@pytest.mark.parametrize("dirichlet", [False, True])
def test_mac_projection_div_source_matches_jax(with_solid, dirichlet):
    n = 1 << LEVEL
    rng = np.random.default_rng(17)
    uf = [rng.standard_normal((n + 1, n)), rng.standard_normal((n, n + 1))]
    src = 0.5 + rng.standard_normal((n, n))
    p0 = np.zeros((n, n))
    jgrid, tgrid = JGrid(LEVEL), Grid(LEVEL)
    jkw, tkw = {}, {}
    if with_solid:
        ja, js = jsolid.solid_fractions(jgrid, _jphi)
        ta, ts = solid.solid_fractions(tgrid, _tphi, device="cpu")
        jkw = dict(face_frac=tuple(js), vol_frac=ja)
        tkw = dict(face_frac=tuple(ts), vol_frac=ta)
    jmp = jpoisson.MultilevelParams(tolerance=1e-10, nitermax=20)
    tmp = poisson.MultilevelParams(tolerance=1e-10, nitermax=20)
    jout = jproj.mac_projection([jnp.asarray(u) for u in uf],
                                jnp.asarray(p0), jgrid,
                                _pbc(jbc, dirichlet), DT, jmp,
                                div_source=jnp.asarray(src), **jkw)
    tout = tproj.mac_projection([torch.from_numpy(u) for u in uf],
                                torch.from_numpy(p0), tgrid,
                                _pbc(bc, dirichlet), DT, tmp,
                                div_source=torch.from_numpy(src), **tkw)
    for c in range(2):
        assert _rel(jout[0][c], tout[0][c]) <= RTOL, f"face {c}"
        assert _rel(jout[2][c], tout[2][c]) <= RTOL, f"g_cell {c}"
    assert _rel(jout[1], tout[1], mean_free=not dirichlet) <= RTOL, "P"
    assert tout[3].niter == int(jout[3].niter)
