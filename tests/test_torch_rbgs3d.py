"""K13 ``rbgs_relax_3d``: the port's plain version (CPU, float64) against
the JAX package's Pallas kernel run in interpret mode, as
tests/test_mgfuse.py runs it (a single strip at 32^3, and a
strip-decomposed (64, 32, 32) level with 16-row strips), and against the
reference's jnp ``poisson.relax``; the 3D ``relax`` routes (K13 where
every side is Dirichlet or Neumann and the ghosts homogeneous, the torch
route otherwise); the wrapper's input checks.  Tolerance: 1e-12 of
max|ref| at every cell.  That a CUDA tensor never reaches the plain
version is tests/test_torch_cuda.py's (it needs the card)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import rbgs3d as jrbgs3d  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs3d  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

BOUND = 1e-12
# the reference's cases (tests/test_mgfuse.py:439-482)
CASES = {
    "dirichlet": (jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 3), (-1.0,) * 6),
    "neumann": (jbc.FieldBC.uniform(jbc.Neumann(), 3), (1.0,) * 6),
    "mixed": (jbc.FieldBC(((jbc.Dirichlet(0.0), jbc.Neumann()),
                           (jbc.Neumann(), jbc.Dirichlet(0.0)),
                           (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0)))),
              (-1.0, 1.0, 1.0, -1.0, -1.0, -1.0)),
}


def _fields(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


@pytest.mark.parametrize("kind", list(CASES))
def test_rbgs_relax_3d_matches_pallas(kind):
    """32^3, 3 sweeps, omega 1.3, dia 0.7: the plain K13 against the
    Pallas K13 and the reference's jnp relax, and the 3D relax route of
    the port (which takes K13 for these BCs) against the same."""
    fbc, signs = CASES[kind]
    grid = JGrid(level=5, dim=3)
    u, rhs = _fields(5, grid.shape)
    kw = dict(nsweeps=3, h2=grid.h ** 2, signs=signs, omega=1.3)
    ref = jrbgs3d.rbgs_relax_3d(jnp.asarray(u), jnp.asarray(rhs), 0.7,
                                interpret=True, **kw)
    assert np.asarray(ref).dtype == np.float64
    got = rbgs3d.rbgs_relax_3d(torch.from_numpy(u), torch.from_numpy(rhs),
                               0.7, **kw)
    assert _rel(ref, got) <= BOUND
    jnp_ref = jpoisson.relax(jnp.asarray(u), jnp.asarray(rhs), grid, fbc, 3,
                             dia=0.7, homogeneous=True, omega=1.3)
    assert _rel(jnp_ref, got) <= BOUND
    routed = tpoisson.relax(torch.from_numpy(u), torch.from_numpy(rhs),
                            TGrid(level=5, dim=3), fieldbc_from_jax(fbc), 3,
                            dia=0.7, omega=1.3)
    assert torch.equal(routed, got)


def test_rbgs_relax_3d_strip_decomposed():
    """(64, 32, 32) with the Pallas kernel's 16-row strips and its halo
    (tests/test_mgfuse.py's strip invariance case), Dirichlet and Neumann
    sides mixed, 2 sweeps at omega 1: the plain K13 matches it."""
    u, rhs = _fields(9, (64, 32, 32))
    signs = CASES["mixed"][1]
    kw = dict(nsweeps=2, h2=1e-3, signs=signs)
    ref = jrbgs3d.rbgs_relax_3d(jnp.asarray(u), jnp.asarray(rhs), 0.0, S=16,
                                interpret=True, **kw)
    got = rbgs3d.rbgs_relax_3d(torch.from_numpy(u), torch.from_numpy(rhs),
                               0.0, **kw)
    assert _rel(ref, got) <= BOUND


@pytest.mark.parametrize("sides,homogeneous,kernel", [
    ("walls", True, True),
    ("walls", False, False),
    ("periodic_x", True, False),
    ("periodic", True, False),
])
def test_relax_3d_routes(monkeypatch, sides, homogeneous, kernel):
    """K13 takes homogeneous sweeps with Dirichlet/Neumann sides only;
    periodic sides and inhomogeneous ghosts take the torch route, which
    matches the reference's jnp relax (its inhomogeneous offsets too)."""
    wall = (jbc.Dirichlet(0.5), jbc.Neumann(0.25))
    per = (jbc.Periodic(), jbc.Periodic())
    jfbc = jbc.FieldBC({
        "walls": (wall, wall[::-1], wall),
        "periodic_x": (per, wall, wall[::-1]),
        "periodic": (per, per, per)}[sides])
    calls = []
    k13 = rbgs3d.rbgs_relax_3d
    monkeypatch.setattr(rbgs3d, "rbgs_relax_3d",
                        lambda *a, **k: calls.append(1) or k13(*a, **k))
    jgrid = JGrid(level=4, dim=3)
    u, rhs = _fields(3, jgrid.shape)
    ref = jpoisson.relax(jnp.asarray(u), jnp.asarray(rhs), jgrid, jfbc, 2,
                         dia=0.3, homogeneous=homogeneous, omega=1.2)
    got = tpoisson.relax(torch.from_numpy(u), torch.from_numpy(rhs),
                         TGrid(level=4, dim=3), fieldbc_from_jax(jfbc), 2,
                         dia=0.3, homogeneous=homogeneous, omega=1.2)
    assert bool(calls) == kernel
    assert _rel(ref, got) <= BOUND


def test_rbgs_relax_3d_checks_and_leaves_u():
    u = torch.randn(4, 6, 8, dtype=torch.float64)
    rhs = torch.randn(4, 6, 8, dtype=torch.float64)
    u0 = u.clone()
    kw = dict(nsweeps=1, h2=0.1, signs=(1.0,) * 6)
    out = rbgs3d.rbgs_relax_3d(u, rhs, **kw)
    assert torch.equal(u, u0) and not torch.equal(out, u0)
    assert torch.equal(rbgs3d.rbgs_relax_3d(u, rhs, nsweeps=0, h2=0.1,
                                            signs=(1.0,) * 6), u)
    with pytest.raises(TypeError):
        rbgs3d.rbgs_relax_3d(u.to(torch.int64), rhs, **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(u[0], rhs[0], **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(u, rhs[:, :, :4], **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(u.transpose(0, 2), rhs.transpose(0, 2), **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(u, rhs, nsweeps=1, h2=0.1, signs=(1.0,) * 4)

