"""The Navier and contact-angle BC kinds and the VOF concentrations of the
port, against ``gerris_tpu`` on the CPU in float64, and the Navier slip
channel against its analytic profile.

Navier (``bc.Navier(lambda)``): the ghost (2 lambda - h) / (2 lambda + h)
times the interior on every route, homogeneous or not; the kernels take
no Navier side, so such a field runs the kernels' plain versions (torch)
by its configuration.  Contact (``bc.Contact(theta)``): the fraction pads
as a mirror; ``vof.contact_fill`` extends the interface into the wall at
the angle for the normals, the sweep fluxes and the curvature, whose
heights next to the wall shift by cot(theta).  The sessile drop: a
quarter disk of radius 0.3 in the corner of the bottom wall (the
contact side) and the left wall (the symmetry axis), as the reference's
test/sessile (its steps against gerris_tpu are in
tests/test_torch_css.py).  Inputs are made with numpy from a seed."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg  # noqa: E402
from gerris_tpu_torch.physics import vof as tvof  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (fieldbc_from_jax,  # noqa: E402
                                            grid_from_jax)

FN_RTOL = 1e-13
ANGLES = (60.0, 120.0)


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_nan(a, b):
    """Equal to rounding where finite, NaN at the same cells."""
    a = np.asarray(a)
    b = b.cpu().numpy()
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    ok = np.isfinite(a)
    return float(np.max(np.abs(a[ok] - b[ok])) / np.max(np.abs(a[ok])))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_step_cache():
    yield
    jns.ns_step.clear_cache()


# ---------------------------------------------------------------- Navier

def _navier_bc():
    """Navier 0.05 bottom, Navier 0.4 top, Dirichlet 0.2 left, Neumann
    right."""
    return jbc.FieldBC(((jbc.Dirichlet(0.2), jbc.Neumann(0.0)),
                        (jbc.Navier(0.05), jbc.Navier(0.4))))


@pytest.mark.parametrize("homogeneous", [False, True])
@pytest.mark.parametrize("corners", [True, False])
@pytest.mark.parametrize("width", [1, 2])
def test_apply_bc_navier_matches_jax(width, corners, homogeneous):
    """apply_bc with Navier sides, with and without corners, homogeneous
    or not, one and two ghost layers, bit for bit."""
    jg = JGrid(level=4)
    v = np.random.default_rng(0).standard_normal(jg.shape)
    ref = jbc.apply_bc(jnp.asarray(v), jg, _navier_bc(), width,
                       homogeneous=homogeneous, corners=corners)
    got = tbc.apply_bc(_t(v), grid_from_jax(jg),
                       fieldbc_from_jax(_navier_bc()), width,
                       homogeneous=homogeneous, corners=corners)
    assert np.array_equal(np.asarray(ref), got.numpy())


def test_navier_residual_matches_jax():
    """The residual with Navier sides and inhomogeneous values matches the
    reference's padded route."""
    jg = JGrid(level=5)
    rng = np.random.default_rng(1)
    u, rhs = rng.standard_normal(jg.shape), rng.standard_normal(jg.shape)
    ref = jpoisson.residual(jnp.asarray(u), jnp.asarray(rhs), jg,
                            _navier_bc(), dia=3.0)
    got = tpoisson.residual(_t(u), _t(rhs), grid_from_jax(jg),
                            fieldbc_from_jax(_navier_bc()), 3.0)
    assert _rel(ref, got) <= FN_RTOL


def test_navier_correction_ghosts_take_the_factor():
    """The homogeneous (correction) residual with a Navier side: the port
    reads the Navier ghost factor * interior, as its apply_bc (and the
    reference's apply_bc) does.  The reference's shifted-neighbour route
    (gerris_tpu/solvers/poisson.py:218-234, taken whenever homogeneous)
    pads a Navier side as a mirror instead, and so do its prolongation
    and dense coarsest matrix (a fault: ROADMAP Queue 3)."""
    jg = JGrid(level=4)
    g = grid_from_jax(jg)
    fbc = fieldbc_from_jax(_navier_bc())
    u = _t(np.random.default_rng(2).standard_normal(jg.shape))
    zero = torch.zeros_like(u)
    got = tpoisson.residual(u, zero, g, fbc, homogeneous=True)
    p = tbc.apply_bc(u, g, fbc, 1, homogeneous=True)
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
           - 4.0 * u) / g.h ** 2
    assert float((got + lap).abs().max()) <= 1e-12 * float(lap.abs().max())
    ref = np.asarray(jpoisson.residual(jnp.asarray(u.numpy()),
                                       jnp.zeros(jg.shape), jg,
                                       _navier_bc(), homogeneous=True))
    mirror = tbc.FieldBC(((tbc.Dirichlet(), tbc.Neumann()),
                          (tbc.Neumann(), tbc.Neumann())))
    assert _rel(ref, tpoisson.residual(u, zero, g, mirror,
                                       homogeneous=True)) <= FN_RTOL
    assert _rel(ref, got) > 1e-3


def test_navier_takes_no_kernel():
    """A Navier side, slip 0 included, is outside the kernels' encoding
    (bcg.kernel_spec None; the multigrid's kernel routes refused), and
    its slip length is a constant."""
    for lam in (0.0, 0.1):
        fbc = tbc.FieldBC.make(2, bottom=tbc.Navier(lam))
        assert bcg.kernel_spec(fbc) is None
        assert tbc.static_values(fbc)
        assert not tbc.kernel_ghosts(fbc)
        assert not tbc.kernel_ghosts(fbc, homogeneous=True)
    with pytest.raises(ValueError):
        tbc.Navier(lambda x, y: 0.1)


def slip_cfg(level, lam, G=1.0, nu=1.0):
    """The slip channel: periodic in x, Navier walls of slip length
    ``lam`` for U at y = +-0.5 (V Dirichlet 0), driven by the body force
    G along x; solves to 1e-12."""
    per = (tbc.Periodic(), tbc.Periodic())
    mp = tpoisson.MultilevelParams(tolerance=1e-12, nitermax=200)
    return tns.NSConfig(
        grid=Grid(level=level),
        u_bcs=(tbc.FieldBC((per, (tbc.Navier(lam), tbc.Navier(lam)))),
               tbc.FieldBC((per, (tbc.Dirichlet(), tbc.Dirichlet())))),
        nu=nu, beta=1.0, body_force=(G, None), projection=mp,
        approx_projection=mp, diffusion_params=mp)


def test_slip_channel_second_order():
    """Steady Stokes flow in the slip channel: u(y) = G / (2 nu) (1/4 -
    y^2 + lambda), which the step reaches from rest in a few implicit
    steps of dt = 10 (the steady state does not depend on dt).  The error
    at 8, 16 and 32 rows falls by 4 a level (second order), and V stays
    0."""
    lam, G, nu = 0.1, 1.0, 1.0
    errs = []
    for level in (3, 4, 5):
        cfg = slip_cfg(level, lam, G, nu)
        s = Simulation(cfg, time=Time(dtmax=10.0), device="cpu")
        s.init().run(max_steps=12)
        y = torch.as_tensor(cfg.grid.axis_centers(1))
        exact = G / (2 * nu) * (0.25 - y * y + lam)
        U = s.state["U"]
        assert float((U - U[:1]).abs().max()) <= 1e-10
        assert float(s.state["V"].abs().max()) <= 1e-10
        errs.append(float((U[0] - exact).abs().max()))
    ratios = [errs[k] / errs[k + 1] for k in range(2)]
    assert errs[-1] < 2e-3 and all(3.6 < r < 4.4 for r in ratios), \
        (errs, ratios)


# --------------------------------------------------------------- Contact

def sessile_T(grid):
    """The quarter disk of radius 0.3 centred at (-0.5, -0.5)."""
    return np.array(jvof.fraction_from_levelset(
        grid, lambda x, y: 0.09 - ((x + 0.5) ** 2 + (y + 0.5) ** 2)))


def contact_bc(angle, side="bottom"):
    return jbc.FieldBC.make(2, **{side: jbc.Contact(angle)})


def angle_jax(x, y, t):
    return 90.0 + 40.0 * jnp.tanh(4.0 * x) + 0.0 * y + 10.0 * t


def angle_torch(x, y, t):
    return 90.0 + 40.0 * torch.tanh(4.0 * x) + 0.0 * y + 10.0 * t


def _contact_pair(angle, side="bottom"):
    """(JAX FieldBC, port FieldBC) with a contact side."""
    if angle == "callable":
        j = contact_bc(angle_jax, side)
        ax, sd = {"bottom": (1, 0), "left": (0, 0), "top": (1, 1)}[side]
        return j, fieldbc_from_jax(j, {(ax, sd): angle_torch})
    j = contact_bc(angle, side)
    return j, fieldbc_from_jax(j)


@pytest.mark.parametrize("angle", ANGLES + ("callable",))
def test_contact_fill_and_normals_match_jax(angle):
    """contact_fill of the drop's 3-ghost pad (the ghost band below the
    bottom wall), and the contact-filled MYC normals, at 32^2."""
    jg = JGrid(level=5)
    g = grid_from_jax(jg)
    T = sessile_T(jg)
    jfbc, tfbc = _contact_pair(angle)
    ref = jvof.contact_fill(jbc.apply_bc(jnp.asarray(T), jg, jfbc, 3), 3,
                            jg, jfbc, t=0.2)
    got = tvof.contact_fill(tbc.apply_bc(_t(T), g, tfbc, 3), 3, g, tfbc,
                            t=0.2)
    assert _rel(ref, got) <= FN_RTOL
    assert not np.array_equal(np.asarray(ref),
                              np.asarray(jbc.apply_bc(jnp.asarray(T), jg,
                                                      jfbc, 3)))
    for r, gt in zip(jvof.normals(jnp.asarray(T), jg, jfbc, t=0.2),
                     tvof.normals(_t(T), g, tfbc, t=0.2)):
        assert _rel(r, gt) <= FN_RTOL


@pytest.mark.parametrize("angle", ANGLES + ("callable",))
def test_contact_curvature_matches_jax(angle):
    """The height-function curvature (with its cot(theta) shifts at the
    contact wall) and the parabola fit on the contact-filled pad, at
    32^2 (NaN off the interface)."""
    jg = JGrid(level=5)
    g = grid_from_jax(jg)
    T = sessile_T(jg)
    jfbc, tfbc = _contact_pair(angle)
    ref = jvof.curvature(jnp.asarray(T), jg, jfbc, t=0.2)
    got = tvof.curvature(_t(T), g, tfbc, t=0.2)
    assert _same_nan(ref, got) <= FN_RTOL
    mx, my = jvof.normals(jnp.asarray(T), jg, jfbc, t=0.2)
    ref = jvof.parabola_curvature(jnp.asarray(T), jg, jfbc, mx, my, t=0.2)
    got = tvof.parabola_curvature(_t(T), g, tfbc, _t(mx), _t(my), t=0.2)
    assert _same_nan(ref, got) <= FN_RTOL


@pytest.mark.parametrize("side", ["bottom", "left"])
@pytest.mark.parametrize("angle", ANGLES)
def test_contact_sweep_flux_matches_jax(angle, side):
    """A sweep's geometric flux along each axis through the contact-filled
    2-ghost pad, with random faces at 32^2 (CFL 0.4)."""
    jg = JGrid(level=5)
    g = grid_from_jax(jg)
    T = sessile_T(jg)
    jfbc, tfbc = _contact_pair(angle, side)
    rng = np.random.default_rng(3)
    uf = [rng.uniform(-1.0, 1.0, jg.face_shape(c)) for c in range(2)]
    dt = 0.4 * jg.h
    for c in range(2):
        rf, ru = jvof.sweep_flux(jnp.asarray(T), [jnp.asarray(u) for u in uf],
                                 jg, jfbc, c, dt)
        gf, gu = tvof.sweep_flux(_t(T), [_t(u) for u in uf], g, tfbc, c, dt)
        assert _rel(rf, gf) <= FN_RTOL and _rel(ru, gu) <= FN_RTOL


def test_contact_below_min_cells_pads_a_mirror():
    """Below 12 cells a side contact_fill keeps the mirror ghosts and the
    heights take no shift, as the reference's."""
    jg = JGrid(level=3)
    g = grid_from_jax(jg)
    T = sessile_T(jg)
    jfbc, tfbc = _contact_pair(60.0)
    pad = tbc.apply_bc(_t(T), g, tfbc, 2)
    assert torch.equal(tvof.contact_fill(pad, 2, g, tfbc), pad)
    assert _same_nan(jvof.curvature(jnp.asarray(T), jg, jfbc),
                     tvof.curvature(_t(T), g, tfbc)) <= FN_RTOL


@pytest.mark.parametrize("cstart", [0, 1])
def test_concentrations_match_jax(cstart):
    """vof.advect with a concentration: the case of tests/test_vof.py
    (a periodic slab carrying c = 1 + cos(2 pi y), 24 steps at 64^2),
    and the same case with the reference's own gates: the amount c f
    conserved, c bounded and confined to the phase."""
    jg = JGrid(level=6)
    g = grid_from_jax(jg)
    per = jbc.FieldBC.uniform(jbc.Periodic(), 2)
    x, y = jg.centers
    f = jvof.fraction_from_levelset(
        jg, lambda X, Y, z=0.0, t=0.0: 0.15 - jnp.abs(X))
    c = jnp.where(f > 0.5, 1.0 + jnp.cos(2 * jnp.pi * y), 0.0)
    uf = [jnp.ones(jg.face_shape(0)), jnp.zeros(jg.face_shape(1))]
    dt = 0.4 * jg.h
    jf, jc = f, [c]
    tf, tc = _t(f), [_t(c)]
    tper = fieldbc_from_jax(per)
    for i in range(24):
        jf, jc = jvof.advect(jf, uf, jg, per, dt, cstart=(i + cstart) % 2,
                             concentrations=jc)
        tf, tc = tvof.advect(tf, [_t(u) for u in uf], g, tper, dt,
                             cstart=(i + cstart) % 2, concentrations=tc)
    assert _rel(jf, tf) <= FN_RTOL and _rel(jc[0], tc[0]) <= 1e-12
    mass0 = float((_t(c) * _t(f)).sum())
    mass1 = float((tc[0] * tf).sum())
    assert abs(mass1 - mass0) / mass0 < 1e-10
    assert float(tc[0].max()) <= float(c.max()) + 1e-9
    assert float(tc[0].min()) >= -1e-12
    assert float(torch.where(tf < 1e-9, tc[0], 0.0).abs().max()) < 1e-9
    assert isinstance(tvof.advect(tf, [_t(u) for u in uf], g, tper, dt),
                      torch.Tensor)


def test_concentrations_take_their_own_bcs():
    """``cbc``: the concentration's own BCs (a Dirichlet inflow value)
    rather than the fraction's."""
    jg = JGrid(level=5)
    g = grid_from_jax(jg)
    fbc = jbc.FieldBC.make(2, left=jbc.Dirichlet(1.0))
    cbc = jbc.FieldBC.make(2, left=jbc.Dirichlet(2.0))
    rng = np.random.default_rng(4)
    f = np.clip(rng.random(jg.shape) * 1.4 - 0.2, 0.0, 1.0)
    c = rng.random(jg.shape)
    uf = [rng.uniform(0.2, 1.0, jg.face_shape(0)),
          rng.uniform(-0.5, 0.5, jg.face_shape(1))]
    dt = 0.4 * jg.h
    jf, jc = jvof.advect(jnp.asarray(f), [jnp.asarray(u) for u in uf], jg,
                         fbc, dt, concentrations=[jnp.asarray(c)], cbc=cbc)
    tf, tc = tvof.advect(_t(f), [_t(u) for u in uf], g, fieldbc_from_jax(fbc),
                         dt, concentrations=[_t(c)],
                         cbc=fieldbc_from_jax(cbc))
    assert _rel(jf, tf) <= FN_RTOL and _rel(jc[0], tc[0]) <= FN_RTOL


def sessile_jcfg(level, angle):
    """The sessile drop: T with the contact angle on the bottom wall (the
    left wall is the symmetry axis), velocity_bc walls, nu 0.1, tension
    1, unit density, the default adaptive solves (dense coarsest level
    capped at the JAX CPU's 1024 unknowns)."""
    mp = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                   dense_coarse_max=1024)
    return jns.NSConfig(
        grid=JGrid(level=level, dim=2),
        u_bcs=(jbc.velocity_bc(0, 2), jbc.velocity_bc(1, 2)), nu=0.1,
        beta=1.0, vof_tracers=(("T", contact_bc(angle)),),
        tension=(("T", 1.0),), projection=mp, approx_projection=mp,
        diffusion_params=dataclasses.replace(mp, nitermax=10))
