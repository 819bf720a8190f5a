"""The VOF functions only the composite AMR reads
(gerris_tpu_torch/physics/vof.py: prolong_geometric, height_fields)
against the JAX package's on the CPU in float64, with the same fractions
made from seeded level sets: 2D and 3D prolongations to 1e-12, the
children's mean back to the parent, the height columns."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import vof  # noqa: E402


def _fraction(level, dim, seed):
    """A seeded level set's fraction, from the JAX package (numpy)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.2, 0.2, dim)
    r = rng.uniform(0.15, 0.3)
    k = rng.uniform(0.0, 0.1)
    grid = JGrid(level=level, dim=dim)
    if dim == 2:
        phi = lambda x, y: r - jnp.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2) \
            + k * jnp.cos(5 * x)  # noqa: E731
    else:
        phi = lambda x, y, z: r - jnp.sqrt(  # noqa: E731
            (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
    return np.asarray(jvof.fraction_from_levelset(grid, phi))


BCS = [("neumann", jbc.default_scalar_bc, bc.default_scalar_bc),
       ("periodic_x", lambda d: jbc.FieldBC(
           ((jbc.Periodic(), jbc.Periodic()),)
           + ((jbc.Neumann(), jbc.Neumann()),) * (d - 1)),
        lambda d: bc.FieldBC(((bc.Periodic(), bc.Periodic()),)
                             + ((bc.Neumann(), bc.Neumann()),) * (d - 1)))]


@pytest.mark.parametrize("dim,level", [(2, 5), (3, 3)])
@pytest.mark.parametrize("name,jfbc,tfbc", BCS, ids=[b[0] for b in BCS])
def test_prolong_geometric_equals_the_reference(dim, level, name, jfbc,
                                                tfbc):
    f = _fraction(level, dim, seed=dim + level)
    want = np.asarray(jvof.prolong_geometric(
        jnp.asarray(f), JGrid(level=level, dim=dim), jfbc(dim)))
    got = vof.prolong_geometric(torch.tensor(f), Grid(level=level, dim=dim),
                                tfbc(dim))
    assert got.shape == tuple(2 * s for s in f.shape)
    assert float(np.abs(got.numpy() - want).max()) < 1e-12
    # the children average back to the parent
    back = got.reshape(*sum(([s, 2] for s in f.shape), []))
    back = back.mean(dim=tuple(range(1, 2 * dim, 2)))
    assert float((back - torch.tensor(f)).abs().max()) < 1e-12


def test_prolong_is_exact_on_a_line():
    """An oblique line: the coarse reconstruction is the interface, so
    the interior children get the fine fractions exactly."""
    phi = lambda x, y: 0.1 + 0.3 * x - y  # noqa: E731
    f = vof.fraction_from_levelset(Grid(5), phi, device="cpu",
                                   dtype=torch.float64)
    exact = vof.fraction_from_levelset(Grid(6), phi, device="cpu",
                                       dtype=torch.float64)
    fine = vof.prolong_geometric(f, Grid(5), bc.default_scalar_bc(2))
    assert float((fine - exact)[4:-4, 4:-4].abs().max()) < 1e-12


@pytest.mark.parametrize("R", [2, 3])
def test_height_fields_equal_the_reference(R):
    f = _fraction(5, 2, seed=R)
    want = jvof.height_fields(jnp.asarray(f), JGrid(5),
                              jbc.default_scalar_bc(2), R=R)
    got = vof.height_fields(torch.tensor(f), Grid(5),
                            bc.default_scalar_bc(2), R=R)
    for a in (0, 1):
        assert float(np.abs(got[a].numpy() - np.asarray(want[a])).max()) \
            < 1e-13
    assert math.isclose(float(got[0].sum()), float(got[1].sum()),
                        rel_tol=0.05)
