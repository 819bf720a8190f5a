"""K13 ``rbgs_relax_3d`` with the prolongation folded in (CPU).

Every upward level of a 3D correction on Dirichlet/Neumann sides is one
K13 call that places the trilinear prolongation of the coarser level's
correction itself (``coarse=``) and adds u at the finest level
(``add=``).  On the CPU the wrapper runs its plain version, which must be
``poisson.prolong``, then ``rbgs3d_plain``, then the add, bit for bit
(``torch.equal``), in float64 and float32; the 3D ``correction`` on that
route is held to the reference's ``correction``
(gerris_tpu/solvers/poisson.py:520) in float64 to 1e-12 of max|ref|.
The wrapper's checks and its launch plan are checked here too; the
kernel itself is tests/test_torch_cuda.py's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs3d  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

BOUND = 1e-12
# mixed Dirichlet (-1) and Neumann (+1) sides, x lo .. z hi
MIXED = (-1.0, 1.0, 1.0, -1.0, -1.0, 1.0)
MIXED_BC = tbc.FieldBC(((tbc.Dirichlet(0.0), tbc.Neumann()),
                        (tbc.Neumann(), tbc.Dirichlet(0.0)),
                        (tbc.Dirichlet(0.0), tbc.Neumann())))
JCASES = {
    "dirichlet": jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 3),
    "neumann": jbc.FieldBC.uniform(jbc.Neumann(), 3),
    "mixed": jbc.FieldBC(((jbc.Dirichlet(0.0), jbc.Neumann()),
                          (jbc.Neumann(), jbc.Dirichlet(0.0)),
                          (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0)))),
}


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 16, 32)])
@pytest.mark.parametrize("nsweeps", [1, 4])
@pytest.mark.parametrize("omega", [1.0, 1.5])
@pytest.mark.parametrize("with_add", [False, True])
def test_fold_plain_is_prolong_relax_add(dtype, shape, nsweeps, omega,
                                         with_add):
    """The fold's plain version is poisson.prolong, then rbgs3d_plain,
    then + add, bit for bit; the inputs are left as they were."""
    rng = np.random.default_rng(sum(shape) + nsweeps)
    c, rhs, add = (torch.from_numpy(rng.standard_normal(s)).to(dtype)
                   for s in (tuple(n // 2 for n in shape), shape, shape))
    add = add if with_add else None
    c0 = c.clone()
    h2, dia = 1.0 / shape[0] ** 2, 0.4
    got = rbgs3d.rbgs_relax_3d(None, rhs, dia, nsweeps=nsweeps, h2=h2,
                               signs=MIXED, omega=omega, coarse=c, add=add)
    assert tpoisson._signs_offs(None, MIXED_BC, True)[0] == MIXED
    # no Navier side: the prolongation needs no coarse grid
    du = rbgs3d.rbgs3d_plain(tpoisson.prolong(c, MIXED_BC, None), rhs,
                             nsweeps, h2,
                             1.0 / (6.0 + dia * h2), MIXED, omega=omega)
    want = du if add is None else add + du
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(c, c0)


def test_prolong3d_plain_is_poisson_prolong_on_periodic_sides():
    """poisson.prolong in 3D is prolong3d_plain, periodic axes wrapped."""
    per = (tbc.Periodic(), tbc.Periodic())
    fbc = tbc.FieldBC((per, (tbc.Dirichlet(0.0), tbc.Neumann()), per))
    c = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 6, 8)))
    signs = tpoisson._signs_offs(None, fbc, True)[0]
    assert torch.equal(tpoisson.prolong(c, fbc, None), rbgs3d.prolong3d_plain(
        c, signs, (True, False, True)))


@pytest.mark.parametrize("level,kind,dense,with_u", [
    (4, "mixed", 512, True), (5, "neumann", 512, True),
    (5, "dirichlet", 512, False), (4, "mixed", 0, True)])
def test_correction_3d_fold_matches_jax(monkeypatch, level, kind, dense,
                                        with_u):
    """The 3D correction (the dense 8^3 solve, or relaxation from zero at
    minlevel 2, then every upward level one folded K13 call, + u at the
    finest) against the reference's correction, float64, 1e-12."""
    jfbc = JCASES[kind]
    jgrid = JGrid(level=level, dim=3)
    rng = np.random.default_rng(level + dense)
    r, u = rng.standard_normal(jgrid.shape), rng.standard_normal(jgrid.shape)
    kw = dict(nrelax=4, omega=1.5, dense_coarse_max=dense, minlevel=2)
    ref = jpoisson.correction(jnp.asarray(r), jgrid, jfbc,
                              jpoisson.MultilevelParams(**kw), dia=0.3,
                              u_fine=jnp.asarray(u) if with_u else None)
    folds = []
    k13 = rbgs3d.rbgs_relax_3d

    def spy(*a, **k):
        folds.append(k.get("coarse") is not None)
        return k13(*a, **k)

    monkeypatch.setattr(rbgs3d, "rbgs_relax_3d", spy)
    got = tpoisson.correction(
        torch.from_numpy(r), TGrid(level=level, dim=3),
        fieldbc_from_jax(jfbc), tpoisson.MultilevelParams(**kw), dia=0.3,
        u_fine=torch.from_numpy(u) if with_u else None)
    upward = level - (3 if dense else 2)
    assert folds.count(True) == upward
    assert _rel(ref, got) <= BOUND


def test_correction_3d_periodic_keeps_torch_prolong(monkeypatch):
    """Periodic sides keep prolong + relax in torch: no folded K13 call."""
    per = (tbc.Periodic(), tbc.Periodic())
    fbc = tbc.FieldBC((per, (tbc.Dirichlet(0.0), tbc.Neumann()),
                       (tbc.Neumann(), tbc.Neumann())))
    folds = []
    k13 = rbgs3d.rbgs_relax_3d
    monkeypatch.setattr(rbgs3d, "rbgs_relax_3d",
                        lambda *a, **k: folds.append(1) or k13(*a, **k))
    r = torch.from_numpy(np.random.default_rng(4).standard_normal((16,) * 3))
    out = tpoisson.correction(r, TGrid(level=4, dim=3), fbc,
                              tpoisson.MultilevelParams(nrelax=2,
                                                        dense_coarse_max=0,
                                                        minlevel=2))
    assert out.shape == r.shape and not folds


def test_fold_wrapper_checks():
    rhs = torch.zeros(8, 8, 8, dtype=torch.float64)
    c = torch.zeros(4, 4, 4, dtype=torch.float64)
    kw = dict(nsweeps=1, h2=0.1, signs=(1.0,) * 6)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(rhs, rhs, coarse=c, **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(None, rhs, **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(None, rhs, coarse=c[:, :, :2].contiguous(), **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(None, rhs[:, :, :7].contiguous(), coarse=c,
                             **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(None, rhs, coarse=c, add=rhs[0], **kw)
    with pytest.raises(ValueError):
        rbgs3d.rbgs_relax_3d(None, rhs, coarse=c.float(), **kw)
    out = rbgs3d.rbgs_relax_3d(None, rhs + 1.0, nsweeps=0, h2=0.1,
                               signs=(1.0,) * 6, coarse=c + 2.0, add=rhs)
    assert torch.equal(out, torch.full_like(rhs, 2.0))


def test_plan():
    """As many blocks of 512 threads as fit on the card, walking bricks of
    4 x 8 rows, unless the test-only knobs say otherwise."""
    assert rbgs3d.plan() == (0, 512, (4, 8))
    assert rbgs3d.plan(7, 256, (1, 2)) == (7, 256, (1, 2))
    with pytest.raises(ValueError):
        rbgs3d.plan(threads=1024)
    with pytest.raises(ValueError):
        rbgs3d.plan(brick=(4, 0))
    with pytest.raises(ValueError):
        rbgs3d.plan(brick=(4, 8, 2))
