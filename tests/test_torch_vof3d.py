"""The port's 3D VOF (gerris_tpu_torch physics/vof.py: the plane geometry,
the 3D MYC normals, the single-band sweeps with concentrations, the 3D
height-function curvature and the level-set fractions) against
``gerris_tpu`` on the same seeded inputs (CPU, float64, 8^3-16^3), then
the 3D gates of tests/test_vof3d.py and tests/test_vof.py on the port,
and the step's 3D two-phase helpers (models/ns.py) on the 3D bubble's
state.

Tolerance: 1e-12 of max|ref| at every cell, NaN exactly where the
reference has NaN.  None of these functions runs a TPU kernel: the
reference writes them in jnp, the port in torch.  The JAX side runs
eagerly, one primitive at a time, so that no fused expression of its
compiler rounds otherwise than the port's."""
import dataclasses
import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.physics import tension as jtens  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.physics import tension as ttens  # noqa: E402
from gerris_tpu_torch.physics import vof as tvof  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            fieldbc_from_jax,
                                            state_from_numpy)

from test_torch_bubble3d import (NAMES, _bubble_T, _rel,  # noqa: E402
                                 bubble3d_jcfg, mu_torch)

BOUND = 1e-12
R = 0.3


def _same(ref, got, bound=BOUND):
    """NaN exactly where the reference has NaN, the rest within bound of
    max|ref|."""
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got))
    if nan.all():
        return
    scale = max(np.max(np.abs(ref[~nan])), 1e-300)
    assert np.max(np.abs(ref[~nan] - got[~nan])) / scale <= bound


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64).copy())


def _sphere(x, y, z, c=(0.0, 0.0, 0.0), r=R):
    return r * r - ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)


def _fractions(level, c=(0.0, 0.0, 0.0), r=R, refine=0):
    """(JAX fraction, port fraction) of the same sphere."""
    def phi(x, y, z):
        return _sphere(x, y, z, c, r)
    return (jvof.fraction_from_levelset(JGrid(level=level, dim=3), phi,
                                        refine=refine),
            tvof.fraction_from_levelset(TGrid(level=level, dim=3), phi,
                                        refine=refine, device="cpu"))


def _bcs(kind):
    return {"neumann": jbc.default_scalar_bc(3),
            "periodic": jbc.periodic_bc(3),
            "mixed": jbc.FieldBC(((jbc.Periodic(), jbc.Periodic()),
                                  (jbc.Neumann(), jbc.Neumann()),
                                  (jbc.Dirichlet(0.0), jbc.Neumann())))}[kind]


def _random_fraction(n, seed):
    """A random field with pure cells (clipped uniform)."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.uniform(-0.5, 1.5, (n, n, n)), 0.0, 1.0)


# --- plane geometry ----------------------------------------------------------

def test_plane_geometry_matches_jax():
    """plane_volume_positive, plane_alpha_positive (the 40-step bisection),
    box_fraction and positive_normal_3d on random normals whose
    components are at least 0.02 (sub-boxes at least 0.1 wide), with
    degenerate ones (one component 0 or 1e-15, which the reference takes
    as 0, two 0), c = 0 and c = 1.  The reference's closed form loses
    digits as 1 / (its smallest component): where that is small but not
    negligible the port holds exact values instead
    (test_plane_volume_small_components)."""
    rng = np.random.default_rng(0)
    n = 600
    m = 0.02 + 0.94 * rng.dirichlet((1, 1, 1), n)
    m[:30, 0] = 0.0
    m[30:60, 1] = 1e-15
    m[60:90, :2] = (0.0, 0.0)
    m[90:100] = (1.0, 0.0, 0.0)
    m[100:110] = (1 / 3, 1 / 3, 1 / 3)
    m /= m.sum(axis=1, keepdims=True)
    c = rng.uniform(-0.1, 1.1, n)
    c[110:130] = 0.0
    c[130:150] = 1.0
    a = rng.uniform(-0.2, 1.2, n)
    mj = [m[:, k] for k in range(3)]
    mt = [_t(m[:, k]) for k in range(3)]
    _same(jvof.plane_volume_positive(*mj, a),
          tvof.plane_volume_positive(*mt, _t(a)))
    aj = jvof.plane_alpha_positive(*mj, c)
    at = tvof.plane_alpha_positive(*mt, _t(c))
    _same(aj, at)
    assert float(at[110:130].abs().max()) == 0.0
    assert float((at[130:150] - 1.0).abs().max()) == 0.0
    b0 = [rng.uniform(0, 0.5, n) for _ in range(3)]
    b1 = [b + rng.uniform(0.1, 0.5, n) for b in b0]
    _same(jvof.box_fraction(*mj, a, b0, b1),
          tvof.box_fraction(*mt, _t(a), [_t(b) for b in b0],
                            [_t(b) for b in b1]))
    s = rng.standard_normal((3, n))
    for r, g in zip(jvof.positive_normal_3d(*s, a),
                    tvof.positive_normal_3d(*(_t(x) for x in s), _t(a))):
        _same(r, g)


def test_plane_geometry_float32_finite():
    """In float32 the closed form's denominator underflows where two
    components are tiny; the degenerate branch is taken there and no NaN
    or inf comes through, and the bisection inverts the volume to
    float32's rounding, degenerate normals among them."""
    m = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1e-20, 1e-20],
                      [1.0 - 2e-10, 1e-10, 1e-10], [0.5, 0.5, 0.0],
                      [1 / 3, 1 / 3, 1 / 3], [0.7, 0.2, 0.1]],
                     dtype=torch.float32)
    for c in (0.0, 1e-7, 0.3, 0.5, 1.0 - 1e-7, 1.0):
        cc = torch.full((6,), c, dtype=torch.float32)
        a = tvof.plane_alpha_positive(m[:, 0], m[:, 1], m[:, 2], cc)
        v = tvof.plane_volume_positive(m[:, 0], m[:, 1], m[:, 2], a)
        assert bool(torch.isfinite(a).all() & torch.isfinite(v).all())
        assert float((v - cc).abs().max()) < 1e-5


def _exact_volume(m, a):
    """The volume below m.x = a in the unit cube in exact rationals (the
    inclusion-exclusion closed form, every component > 0)."""
    m = [Fraction(x) for x in m]
    s = sum(m)
    m = [x / s for x in m]
    a = min(max(Fraction(a), Fraction(0)), Fraction(1))

    def p3(x):
        return x ** 3 if x > 0 else Fraction(0)

    num = p3(a) - sum(p3(a - x) for x in m) \
        + sum(p3(a - m[i] - m[j]) for i in range(3) for j in range(i + 1, 3)) \
        - p3(a - 1)
    return float(num / (6 * m[0] * m[1] * m[2]))


def test_plane_volume_small_components():
    """The port's piecewise volume against exact rationals where one or
    two components are small (1e-2 down to 1e-12 of the largest), in
    float64 to 4e-16 and float32 to 2e-7, and its bisection inverting it
    (to 2e-12 and 2e-6).  The reference's closed form, which the port
    does not copy, cancels there: in float32 its (1 - 2d, d, d) holds no
    volume below alpha = 0.3 at d = 1e-5, and in float64 its (1, 1e-20,
    1e-20) none, whose alpha is then 1 for any fraction (gerris_tpu
    vof.py:103-145; ROADMAP Queue 3)."""
    rng = np.random.default_rng(2)
    rows = []
    for d in (1e-2, 1e-4, 1e-6, 1e-8, 1e-10, 1e-12):
        for two in (False, True):
            for _ in range(20):
                r = rng.uniform(0.05, 1.0, 3)
                r[0] = d * rng.uniform(0.5, 1.0)
                if two:
                    r[1] = d * rng.uniform(0.5, 1.0)
                rows.append((r / r.sum(), rng.uniform(0.0, 1.0)))
    m = np.array([r[0] for r in rows])
    a = np.array([r[1] for r in rows])
    want = np.array([_exact_volume(*r) for r in rows])
    # and alpha in the narrow windows where a branch divides by b1: within
    # b1 of b2, and between b3 and 1/2 where b3 <= b1 + b2 (there the
    # form loses up to ~eps^(2/3): 2e-11, 2e-5)
    edge = []
    for d in (1e-1, 1e-2, 3e-3, 1e-3, 1e-5, 1e-7, 1e-10):
        for _ in range(10):
            b = np.array([d, rng.uniform(d, 0.5), 1.0])
            b /= b.sum()
            edge.append((b, b[1] + rng.uniform(0.0, 1.0) * b[0]))
            e = np.array([d, 0.5 - d / 2 + rng.uniform(-d, d) / 4, 0.0])
            e[2] = 1.0 - e[0] - e[1]
            edge.append((e, rng.uniform(max(e[1], e[2]), 0.5)))
    me = np.array([r[0] for r in edge])
    ae = np.array([r[1] for r in edge])
    want_e = np.array([_exact_volume(*r) for r in edge])
    for dtype, tol, inv, tol_e in ((torch.float64, 4e-16, 2e-12, 2e-11),
                                   (torch.float32, 2e-7, 2e-6, 2e-5)):
        mt = [torch.from_numpy(me[:, k]).to(dtype) for k in range(3)]
        v = tvof.plane_volume_positive(*mt, torch.from_numpy(ae).to(dtype))
        assert float(np.max(np.abs(v.double().numpy() - want_e))) <= tol_e
        mt = [torch.from_numpy(m[:, k]).to(dtype) for k in range(3)]
        v = tvof.plane_volume_positive(*mt, torch.from_numpy(a).to(dtype))
        assert float(np.max(np.abs(v.double().numpy() - want))) <= tol
        # 40 bisection steps: alpha to 2^-41
        c = tvof.plane_alpha_positive(*mt, v)
        back = tvof.plane_volume_positive(*mt, c).double().numpy()
        assert float(np.max(np.abs(back - v.double().numpy()))) <= inv
    # the reference's closed form
    d = np.array([1e-5], dtype=np.float32)
    m32 = [np.float32(1.0) - 2 * d, d, d]
    third = np.array([0.3], dtype=np.float32)
    assert float(jvof.plane_volume_positive(*m32, third)[0]) == 0.0
    got = tvof.plane_volume_positive(*(torch.from_numpy(x) for x in m32),
                                     torch.from_numpy(third))
    assert abs(float(got[0]) - 0.3) < 1e-5
    m64 = [np.array([1.0]), np.array([1e-20]), np.array([1e-20])]
    assert float(jvof.plane_volume_positive(*m64, np.array([0.3]))[0]) == 0.0
    assert float(jvof.plane_alpha_positive(*m64, np.array([0.3]))[0]) == \
        pytest.approx(1.0, abs=1e-11)
    got = tvof.plane_alpha_positive(*(_t(x) for x in m64),
                                    _t(np.array([0.3])))
    assert float(got[0]) == pytest.approx(0.3, abs=1e-11)


# --- normals and reconstruction ----------------------------------------------

@pytest.mark.parametrize("kind", ["neumann", "periodic", "mixed"])
@pytest.mark.parametrize("field", ["sphere", "random", "plane45"])
def test_normals_and_alpha_match_jax(field, kind):
    """youngs_normals_3d, mycs_normals_3d (through ``normals``, on the
    field padded with its BCs) and reconstruct_alpha_3d; "plane45" is a
    plane at 45 degrees to two axes, where the Youngs components tie and
    argmax takes the first."""
    grid_j, grid_t = JGrid(level=3, dim=3), TGrid(level=3, dim=3)
    if field == "sphere":
        fj, ft = _fractions(3, c=(0.1, -0.05, 0.2))
    elif field == "random":
        f = _random_fraction(8, 1)
        fj, ft = jnp.asarray(f), _t(f)
    else:
        def phi(x, y, z):
            return 0.05 - (x + y) / math.sqrt(2.0) + 0.0 * z
        fj = jvof.fraction_from_levelset(grid_j, phi)
        ft = tvof.fraction_from_levelset(grid_t, phi, device="cpu")
    fbc = _bcs(kind)
    mj = jvof.normals(fj, grid_j, fbc)
    mt = tvof.normals(ft, grid_t, fieldbc_from_jax(fbc))
    for r, g in zip(mj, mt):
        _same(r, g)
    pj = jbc.apply_bc(fj, grid_j, fbc, 1)
    for r, g in zip(jvof.youngs_normals_3d(pj),
                    tvof.youngs_normals_3d(_t(pj))):
        _same(r, g)
    _same(jvof.reconstruct_alpha_3d(fj, *mj),
          tvof.reconstruct_alpha_3d(ft, *mt))


# --- advection ---------------------------------------------------------------

def _faces(grid, seed, scale):
    """Random face velocities of both signs along every axis."""
    rng = np.random.default_rng(seed)
    return [scale * rng.uniform(-1.0, 1.0, grid.face_shape(a))
            for a in range(3)]


@pytest.mark.parametrize("kind", ["neumann", "periodic"])
def test_sweep_flux_matches_jax(kind):
    """One sweep's flux and CFL along each axis, both signs of un, and the
    sweep update (both on a sphere's fraction)."""
    fj, ft = _fractions(3, c=(0.05, 0.0, -0.1))
    grid_j, grid_t = JGrid(level=3, dim=3), TGrid(level=3, dim=3)
    fbc = _bcs(kind)
    uf = _faces(grid_j, 2, 1.0)
    dt = 0.4 * grid_j.h
    for c in range(3):
        flj, unj = jvof.sweep_flux(fj, [jnp.asarray(u) for u in uf], grid_j,
                                   fbc, c, dt)
        flt, unt = tvof.sweep_flux(ft, [_t(u) for u in uf], grid_t,
                                   fieldbc_from_jax(fbc), c, dt)
        assert bool((unt > 0).any() & (unt < 0).any())
        _same(flj, flt)
        _same(unj, unt)
        dv = np.ones(grid_j.shape)
        for r, g in zip(jvof.sweep_update(fj, dv, flj, unj, c),
                        tvof.sweep_update(ft, _t(dv), flt, unt, c)):
            _same(r, g)


@pytest.mark.parametrize("kind", ["neumann", "periodic"])
@pytest.mark.parametrize("cstart", [0, 1, 2])
def test_advect_concentrations_match_jax(cstart, kind):
    """One advection step (three sweeps from ``cstart``) of a sphere's
    fraction carrying a concentration, on walls and periodic BCs."""
    fj, ft = _fractions(3, c=(0.0, 0.1, 0.05))
    grid_j, grid_t = JGrid(level=3, dim=3), TGrid(level=3, dim=3)
    fbc = _bcs(kind)
    uf = _faces(grid_j, 3 + cstart, 1.0)
    conc = 1.0 + np.random.default_rng(7).uniform(0.0, 1.0, grid_j.shape)
    dt = 0.3 * grid_j.h
    fj2, cj = jvof.advect(fj, [jnp.asarray(u) for u in uf], grid_j, fbc, dt,
                          cstart=cstart, concentrations=[jnp.asarray(conc)])
    ft2, ct = tvof.advect(ft, [_t(u) for u in uf], grid_t,
                          fieldbc_from_jax(fbc), dt, cstart=cstart,
                          concentrations=[_t(conc)])
    _same(fj2, ft2)
    _same(cj[0], ct[0])


# --- curvature ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["centre", "wall", "random"])
def test_curvature_3d_matches_jax(case):
    """curvature (its 3D branch) with equal NaN masks: a centred sphere at
    level 4, a sphere near a wall, whose columns read the edge and corner
    ghosts, and a random field; then fill_curvature (nD) on the result."""
    if case == "random":
        f = _random_fraction(8, 4)
        fj, ft = jnp.asarray(f), _t(f)
        level = 3
    else:
        level = 4
        fj, ft = _fractions(level, c=(0.0, 0.0, 0.0) if case == "centre"
                            else (0.3, -0.3, 0.25), r=0.25)
    grid_j, grid_t = JGrid(level=level, dim=3), TGrid(level=level, dim=3)
    fbc = _bcs("neumann")
    kj = jvof.curvature(fj, grid_j, fbc)
    kt = tvof.curvature(ft, grid_t, fieldbc_from_jax(fbc))
    _same(kj, kt)
    if case != "random":
        assert bool(torch.isfinite(kt).any())
    _same(jvof.fill_curvature(kj, None, niter=2),
          tvof.fill_curvature(kt, None, niter=2))


# --- level-set fractions -----------------------------------------------------

@pytest.mark.parametrize("refine", [0, 1])
def test_fraction_from_levelset_matches_jax(refine):
    fj, ft = _fractions(3, c=(0.1, 0.0, -0.05), refine=refine)
    assert ft.dtype == torch.float64 and ft.is_contiguous()
    _same(fj, ft)


# --- the gates of tests/test_vof3d.py and tests/test_vof.py on the port ------

def test_mycs_normals_3d_gate():
    """tests/test_vof3d.py::test_mycs_normals_3d: the normals within ~14
    degrees of the sphere's everywhere on the interface (cos > 0.97)."""
    grid = TGrid(level=5, dim=3)
    T = tvof.fraction_from_levelset(grid, _sphere, device="cpu")
    mx, my, mz = tvof.normals(T, grid, tbc.default_scalar_bc(3))
    x, y, z = (_t(a) for a in grid.centers)
    r = torch.sqrt(x * x + y * y + z * z) + 1e-30
    m2 = torch.sqrt(mx ** 2 + my ** 2 + mz ** 2) + 1e-30
    cosang = (mx * x / r + my * y / r + mz * z / r) / m2
    ifc = (T > 1e-6) & (T < 1 - 1e-6)
    assert float(torch.where(ifc, cosang, 1.0).min()) > 0.97


def test_curvature_3d_gate():
    """tests/test_vof3d.py::test_curvature_3d_sphere: the height functions
    valid on most of the sphere, within 15% of 2/R at level 5 and
    converging from level 4."""
    fbc = tbc.default_scalar_bc(3)
    errs = []
    for lvl in (4, 5):
        grid = TGrid(level=lvl, dim=3)
        T = tvof.fraction_from_levelset(grid, _sphere, device="cpu")
        kap = tvof.curvature(T, grid, fbc)
        ifc = (T > 1e-6) & (T < 1 - 1e-6)
        ok = ifc & torch.isfinite(kap)
        exact = 2.0 / R
        rel = torch.where(ok, (kap - exact).abs() / exact, 0.0)
        assert float(ok.sum()) / max(float(ifc.sum()), 1.0) > 0.6
        errs.append(float(rel.max()))
    assert errs[-1] < 0.15
    assert errs[-1] < errs[0]


def test_3d_sphere_fraction_and_advection_gate():
    """tests/test_vof.py::test_3d_sphere_fraction_and_advection: the
    sphere's volume within 2% at 32^3, and 10 periodic advection steps
    (cstart rotating) conserve it to 1e-10, bounded in [0, 1]."""
    grid = TGrid(level=5, dim=3)
    r = 0.25
    f0 = tvof.fraction_from_levelset(
        grid, lambda x, y, z: _sphere(x, y, z, r=r), device="cpu")
    vol = float(f0.sum()) * grid.h ** 3
    exact = 4.0 / 3.0 * math.pi * r ** 3
    assert abs(vol - exact) / exact < 2e-2
    uf = [torch.full(grid.face_shape(a), v, dtype=torch.float64)
          for a, v in enumerate((1.0, 0.5, -0.25))]
    per = tbc.FieldBC.uniform(tbc.Periodic(), 3)
    f = f0
    for i in range(10):
        f = tvof.advect(f, uf, grid, per, 0.4 * grid.h, cstart=i % 3)
    assert abs(float(f.sum() - f0.sum())) / float(f0.sum()) < 1e-10
    assert float(f.min()) >= 0.0 and float(f.max()) <= 1.0


# --- the step's 3D two-phase helpers on the 3D bubble's state ---------------

def _force_t(x, y, z, t=0.0):
    return -0.98 + 0.1 * x * z * (1.0 + t) + 0.0 * y


def test_twophase_fields_3d_match_jax():
    """The step's 3D two-phase helpers on the bubble's state (random
    velocities) at 16 x 32 x 16, against gerris_tpu within 1e-12 of max:
    ``filtered`` (two passes), ``density_fields``, ``viscosity_field``,
    ``viscous_transpose_sources``, ``tension_sources`` (the 3D
    curvature, filled twice, times sigma grad T and alpha),
    ``tension.stability_dt`` and ``timescale`` with a body force; then
    ``body_force_sources`` of a force f(x, y, z, t) at the centres of V's
    faces, absent on the walls y = 0 and 2 (where the reference zeroes
    it too)."""
    jcfg = bubble3d_jcfg(4)
    tcfg = config_from_jax(jcfg, nu_var=mu_torch)
    grid = jcfg.grid
    rng = np.random.default_rng(5)
    st = {n: rng.standard_normal(grid.shape) for n in NAMES}
    st["T"] = _bubble_T(grid)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = state_from_numpy(st, device="cpu")
    fbc = tcfg.vof_tracers[0][1]
    assert _rel(jns.filtered(js["T"], grid, jcfg.vof_tracers[0][1], 2),
                tns.filtered(ts["T"], tcfg.grid, fbc, 2)) <= 1e-12
    jrho, jal = jns.density_fields(js, jcfg, 0.0)
    trho, tal = tns.density_fields(ts, tcfg)
    assert _rel(jrho, trho) <= 1e-12
    for a, b in zip(jal, tal):
        assert _rel(a, b) <= 1e-12
    jmu = jns.viscosity_field(js, jcfg, 0.0)
    tmu = tns.viscosity_field(ts, tcfg)
    assert _rel(jmu, tmu) <= 1e-12
    for a, b in zip(
            jns.viscous_transpose_sources([js[n] for n in "UVW"], jmu, grid,
                                          jcfg, 1.0 / jrho, 0.0),
            tns.viscous_transpose_sources([ts[n] for n in "UVW"], tmu,
                                          tcfg.grid, tcfg, 1.0 / trho)):
        assert _rel(a, b) <= 1e-12
    jfs = jns.tension_sources(js, jcfg, 0.0, alpha=jal)
    tfs = tns.tension_sources(ts, tcfg, alpha=tal)
    for a, b in zip(jfs, tfs):
        assert bool(b.abs().max() > 0.0)
        assert _rel(a, b) <= 1e-12
    assert ttens.stability_dt(tcfg.grid, 24.5, 1000.0, 100.0) == \
        jtens.stability_dt(grid, 24.5, 1000.0, 100.0)
    assert float(tns.timescale(ts, tcfg)) == pytest.approx(
        float(jns.timescale(js, jcfg)), rel=1e-14)
    cfg_f = dataclasses.replace(tcfg, body_force=(None, _force_t, None))
    fx, fy, fz = tns.body_force_sources(cfg_f, ts["U"], t=0.5)
    assert fy.shape == (16, 33, 16)
    assert torch.all(fx == 0.0) and torch.all(fz == 0.0)
    x = torch.as_tensor(grid.axis_centers(0))[:, None, None]
    y = torch.as_tensor(grid.axis_faces(1))[None, :, None]
    z = torch.as_tensor(grid.axis_centers(2))[None, None, :]
    want = torch.broadcast_to(_force_t(x, y, z, t=0.5), fy.shape).clone()
    want[:, 0] = want[:, -1] = 0.0
    assert torch.equal(fy, want)
