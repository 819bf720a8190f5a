"""The block-windowed corrector advection (gerris_tpu_torch/solvers/
blockadv.py) against the JAX package's on the CPU in float64 (seeded
fields and faces on a graded ring mesh, both components, every level,
the lid's Dirichlet faces and Neumann sides, the centred and van Leer
slopes), and against the port's own dense chain on the active blocks
(the same arithmetic: bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.solvers import advection as jadv  # noqa: E402
from gerris_tpu.solvers import blockadv as jbadv  # noqa: E402
from gerris_tpu.solvers import blockrt as jrt  # noqa: E402
from gerris_tpu.solvers import composite as jcomp  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.solvers import advection as adv  # noqa: E402
from gerris_tpu_torch.solvers import blockadv  # noqa: E402
from gerris_tpu_torch.solvers import blockrt  # noqa: E402

LMIN, LMAX = 4, 6


def _mesh():
    gf = JGrid(level=LMAX)
    x, y = (np.asarray(c) for c in gf.centers)
    D = jcomp.grade_depth_map(np.where(
        np.abs(np.sqrt(x * x + y * y) - 0.3) < 4 * gf.h, LMAX,
        LMIN).astype(np.int32))
    return (blockrt.make_blockrt(Grid(LMIN), LMAX, D, device="cpu")[1],
            jrt.make_blockrt(JGrid(LMIN), LMAX, D)[1])


def _level(l, seed):
    g = Grid(l)
    rng = np.random.default_rng(seed)
    return (g, rng.standard_normal(g.shape), rng.standard_normal(g.shape),
            [rng.standard_normal(g.face_shape(a)) for a in range(2)])


def _bcs(mod, c):
    lid = mod.FieldBC.make(2, default=mod.Dirichlet(0.0),
                           top=mod.Dirichlet(1.0))
    return (lid if c == 0 else mod.FieldBC.uniform(mod.Dirichlet(0.0), 2),
            mod.default_scalar_bc(2))


def test_applicable_equals_the_reference():
    for mod, jmod in ((bc, jbc),):
        per = mod.FieldBC(((mod.Periodic(),) * 2, (mod.Neumann(),) * 2))
        jper = jmod.FieldBC(((jmod.Periodic(),) * 2, (jmod.Neumann(),) * 2))
        for scheme in ("godunov", "none"):
            p = adv.AdvectionParams(scheme=scheme)
            jp = jadv.AdvectionParams(scheme=scheme)
            for f, jf in ((per, jper), (_bcs(mod, 0)[0], _bcs(jmod, 0)[0]),
                          (mod.FieldBC.uniform(mod.Contact(60.0), 2),
                           jmod.FieldBC.uniform(jmod.Contact(60.0), 2))):
                assert blockadv.applicable(Grid(4), p, f) == \
                    jbadv.applicable(JGrid(4), jp, jf)


@pytest.mark.parametrize("gradient", ["centered", "van_leer"])
def test_advect_level_equals_the_reference(gradient):
    tables, jtables = _mesh()
    par = adv.AdvectionParams(gradient=gradient)
    jpar = jadv.AdvectionParams(gradient=gradient)
    for l in (LMIN, LMAX):
        g, v, gm, uf = _level(l, l)
        for c in range(2):
            fbc, gbc = _bcs(bc, c)
            jfbc, jgbc = _bcs(jbc, c)
            want = jax.jit(lambda vv, gg, ff: jbadv.advect_level(
                vv, ff, gg, JGrid(l), jfbc, jgbc, 0.01, jpar, jtables[l], 8,
                c))(jnp.asarray(v), jnp.asarray(gm),
                    [jnp.asarray(q) for q in uf])
            got = blockadv.advect_level(
                torch.tensor(v), [torch.tensor(q) for q in uf],
                torch.tensor(gm), g, fbc, gbc, 0.01, par, tables[l], 8, c)
            want = np.asarray(want)
            assert float(np.abs(got.numpy() - want).max()) \
                < 1e-12 * np.abs(want).max(), (l, c)


def test_blocks_equal_the_dense_chain():
    """On the active blocks the windowed chain is the dense chain
    (amr_ns.amr_step phase 3's advection_increment), bit for bit; off
    them it is 0."""
    tables, _ = _mesh()
    par = adv.AdvectionParams()
    for l in range(LMIN, LMAX + 1):
        g, v, gm, uf = _level(l, 10 + l)
        for c in range(2):
            fbc, gbc = _bcs(bc, c)
            vt, gt = torch.tensor(v), torch.tensor(gm)
            ft = [torch.tensor(q) for q in uf]
            got = blockadv.advect_level(vt, ft, gt, g, fbc, gbc, 0.01, par,
                                        tables[l], 8, c)
            dense = adv.advection_increment(
                vt, ft, adv.mac_cell_mean(ft, g), g, fbc, 0.01, par, c=c,
                g_pad=bc.apply_bc(gt, g, gbc, 1))
            act = blockrt.scatter_blocks(
                torch.zeros(g.shape, dtype=torch.bool),
                torch.ones((tables[l]["bx"].shape[0], 8, 8),
                           dtype=torch.bool), tables[l], 8)
            assert torch.equal(got[act], dense[act]), (l, c)
            assert not got[~act].any()
