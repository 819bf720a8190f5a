"""The port's VOF, height-function curvature and tension (gerris_tpu_torch
physics/vof.py, physics/tension.py and the two-phase helpers of
models/ns.py) against ``gerris_tpu`` on the same level-set and random
fields (CPU, float64, 32^2-64^2), then the 2D gates of tests/test_vof.py
on the port.

Tolerance: 1e-12 of max|ref| at every cell (NaN where the reference
has NaN).  None of these functions runs a TPU kernel: the reference
writes them in jnp, the port in torch."""
import math

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
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

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


def _circle_j(x, y):
    return R * R - x * x - y * y


def _circle_t(x, y):
    return R * R - x * x - y * y


def _wavy_j(x, y):
    return -(y - 0.1 * jnp.cos(2 * jnp.pi * x) - 0.05 * jnp.sin(6 * x))


def _wavy_t(x, y):
    return -(y - 0.1 * torch.cos(2 * torch.pi * x) - 0.05 * torch.sin(6 * x))


def _fractions(level, shape="circle"):
    """(JAX fraction, port fraction) of the same level set."""
    jg, tg = JGrid(level=level), TGrid(level=level)
    fj, ft = {"circle": (_circle_j, _circle_t),
              "wavy": (_wavy_j, _wavy_t)}[shape]
    return (jvof.fraction_from_levelset(jg, fj),
            tvof.fraction_from_levelset(tg, ft, device="cpu"))


def _bcs(kind):
    return {"neumann": jbc.default_scalar_bc(2),
            "periodic": jbc.periodic_bc(2),
            "mixed": jbc.FieldBC(((jbc.Periodic(), jbc.Periodic()),
                                  (jbc.Neumann(), jbc.Neumann())))}[kind]


# --- geometry -------------------------------------------------------------------

def test_line_geometry_matches_jax():
    rng = np.random.default_rng(0)
    m1 = rng.uniform(0, 1, 3000)
    m1[:20] = 0.0
    m2 = 1.0 - m1
    c = rng.uniform(-0.1, 1.1, 3000)
    a = rng.uniform(-0.2, 1.2, 3000)
    _same(jvof.line_alpha_positive(m1, m2, c),
          tvof.line_alpha_positive(_t(m1), _t(m2), _t(c)))
    _same(jvof.line_area_positive(m1, m2, a),
          tvof.line_area_positive(_t(m1), _t(m2), _t(a)))
    x0, y0 = rng.uniform(0, 0.5, 3000), rng.uniform(0, 0.5, 3000)
    x1, y1 = x0 + rng.uniform(0, 0.5, 3000), y0 + rng.uniform(0, 0.5, 3000)
    _same(jvof.rectangle_fraction(m1, m2, a, x0, x1, y0, y1),
          tvof.rectangle_fraction(_t(m1), _t(m2), _t(a), _t(x0), _t(x1),
                                  _t(y0), _t(y1)))
    mx, my = rng.standard_normal(3000), rng.standard_normal(3000)
    for r, g in zip(jvof.positive_normal(mx, my, a),
                    tvof.positive_normal(_t(mx), _t(my), _t(a))):
        _same(r, g)


@pytest.mark.parametrize("shape", ["circle", "wavy"])
@pytest.mark.parametrize("level,refine", [(5, 0), (6, 0), (5, 1)])
def test_fraction_from_levelset_matches_jax(level, refine, shape):
    fj, ft = {"circle": (_circle_j, _circle_t),
              "wavy": (_wavy_j, _wavy_t)}[shape]
    ref = jvof.fraction_from_levelset(JGrid(level=level), fj, refine=refine)
    got = tvof.fraction_from_levelset(TGrid(level=level), ft, refine=refine,
                                      device="cpu")
    assert got.dtype == torch.float64 and got.is_contiguous()
    _same(ref, got)


@pytest.mark.parametrize("kind", ["neumann", "periodic"])
@pytest.mark.parametrize("field", ["wavy", "random"])
def test_normals_and_alpha_match_jax(field, kind):
    """MYC normals, the PLIC alpha and the interface points of a level-set
    fraction and of a random field with pure cells."""
    if field == "random":
        rng = np.random.default_rng(1)
        f = np.clip(rng.uniform(-0.5, 1.5, (32, 32)), 0.0, 1.0)
        fj, ft = jnp.asarray(f), _t(f)
    else:
        fj, ft = _fractions(5, "wavy")
    fbc = _bcs(kind)
    mj = jvof.normals(fj, JGrid(level=5), fbc)
    mt = tvof.normals(ft, TGrid(level=5), fieldbc_from_jax(fbc))
    for r, g in zip(mj, mt):
        _same(r, g)
    _same(jvof.reconstruct_alpha(fj, *mj), tvof.reconstruct_alpha(ft, *mt))
    for r, g in zip(jvof.interface_point(fj, *mj),
                    tvof.interface_point(ft, *mt)):
        _same(r, g)


# --- advection --------------------------------------------------------------------

def _faces(seed, n, scale):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal((n + 1, n)),
            scale * rng.standard_normal((n, n + 1))]


@pytest.mark.parametrize("c", [0, 1])
@pytest.mark.parametrize("kind", ["neumann", "mixed"])
def test_sweep_matches_jax(kind, c):
    """One sweep's flux (with the 4-band refinement at interfacial faces)
    and its update, random faces at CFL up to ~0.4."""
    n = 32
    fj, ft = _fractions(5, "circle")
    uf = _faces(2, n, 0.15)
    dt = 0.9 / n
    fbc = _bcs(kind)
    jflux, jun = jvof.sweep_flux(fj, [jnp.asarray(u) for u in uf],
                                 JGrid(level=5), fbc, c, dt)
    tflux, tun = tvof.sweep_flux(ft, [_t(u) for u in uf], TGrid(level=5),
                                 fieldbc_from_jax(fbc), c, dt)
    _same(jflux, tflux)
    _same(jun, tun)
    dV = np.ones((n, n))
    for r, g in zip(jvof.sweep_update(fj, jnp.asarray(dV), jflux, jun, c),
                    tvof.sweep_update(ft, _t(dV), tflux, tun, c)):
        _same(r, g)


@pytest.mark.parametrize("cstart", [0, 1])
def test_advect_matches_jax(cstart):
    """Five full steps of the direction-split advection on a wavy interface
    with random faces, the first direction rotated each step."""
    fj, ft = _fractions(6, "wavy")
    uf = _faces(3, 64, 0.1)
    grid_j, grid_t = JGrid(level=6), TGrid(level=6)
    fbc = _bcs("neumann")
    tfbc = fieldbc_from_jax(fbc)
    dt = 0.3 / 64
    for i in range(5):
        fj = jvof.advect(fj, [jnp.asarray(u) for u in uf], grid_j, fbc, dt,
                         cstart=(cstart + i) % 2)
        ft = tvof.advect(ft, [_t(u) for u in uf], grid_t, tfbc, dt,
                         cstart=(cstart + i) % 2)
    _same(fj, ft)
    with pytest.raises(NotImplementedError):
        tvof.advect(ft, [_t(u) for u in uf], grid_t, tfbc, dt,
                    concentrations=[ft])


# --- curvature and tension ----------------------------------------------------------

@pytest.mark.parametrize("off_max", [0, 2])
@pytest.mark.parametrize("shape,level", [("circle", 5), ("wavy", 6)])
def test_curvature_matches_jax(shape, level, off_max):
    """Height functions (recentred windows up to off_max), the parabola
    fallback, the NaN marking; then fill_curvature and the face pairs."""
    fj, ft = _fractions(level, shape)
    fbc = _bcs("neumann")
    kj = jvof.curvature(fj, JGrid(level=level), fbc, off_max=off_max)
    kt = tvof.curvature(ft, TGrid(level=level), fieldbc_from_jax(fbc),
                        off_max=off_max)
    _same(kj, kt)
    kj, kt = jvof.fill_curvature(kj, None, niter=2), \
        tvof.fill_curvature(kt, None, niter=2)
    _same(kj, kt)
    for axis in (0, 1):
        _same(jtens.face_kappa_pair(kj, axis),
              ttens.face_kappa_pair(kt, axis))


# the parabola fit solves its 3x3 normal equations (sums of up to 4th
# powers) by Cramer's rule: the 1-ulp differences of the interface
# points between XLA's and torch's arithmetic come out ~1e4 times larger
# at the worst-conditioned cell (2.2e-12 of max measured at 32^2)
PARABOLA_BOUND = 1e-10


def test_parabola_curvature_matches_jax():
    fj, ft = _fractions(5, "circle")
    fbc = _bcs("neumann")
    mj = jvof.normals(fj, JGrid(level=5), fbc)
    mt = tvof.normals(ft, TGrid(level=5), fieldbc_from_jax(fbc))
    _same(jvof.parabola_curvature(fj, JGrid(level=5), fbc, *mj),
          tvof.parabola_curvature(ft, TGrid(level=5), fieldbc_from_jax(fbc),
                                  *mt), PARABOLA_BOUND)


def _twophase(level, tbc_kind="neumann"):
    """(JAX, port) NSConfigs with a VOF tracer, tension and density."""
    fbc = _bcs(tbc_kind)
    u_bc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    jcfg = jns.NSConfig(grid=JGrid(level=level), u_bcs=(u_bc, u_bc),
                        nu=1e-3, vof_tracers=(("T", fbc),),
                        tension=(("T", 0.5),), density=("T", 10.0, 1.0, 1))
    tu = fieldbc_from_jax(u_bc)
    tcfg = tns.NSConfig(grid=TGrid(level=level), u_bcs=(tu, tu), nu=1e-3,
                        vof_tracers=(("T", fieldbc_from_jax(fbc)),),
                        tension=(("T", 0.5),), density=("T", 10.0, 1.0, 1))
    return jcfg, tcfg


@pytest.mark.parametrize("kind", ["neumann", "mixed"])
def test_density_and_tension_sources_match_jax(kind):
    """filtered, density_fields (rho per cell, alpha = 1/rho per face) and
    the tension face sources with alpha, on a wavy interface."""
    jcfg, tcfg = _twophase(6, kind)
    fj, ft = _fractions(6, "wavy")
    _same(jns.filtered(fj, jcfg.grid, _bcs(kind), 2),
          tns.filtered(ft, tcfg.grid, fieldbc_from_jax(_bcs(kind)), 2))
    rj, aj = jns.density_fields({"T": fj}, jcfg, 0.0)
    rt, at = tns.density_fields({"T": ft}, tcfg)
    _same(rj, rt)
    for r, g in zip(aj, at):
        _same(r, g)
    sj = jns.tension_sources({"T": fj}, jcfg, 0.0, alpha=aj)
    st = tns.tension_sources({"T": ft}, tcfg, alpha=at)
    for r, g in zip(sj, st):
        _same(r, g)
    grid = tcfg.grid
    assert ttens.stability_dt(grid, 0.5, 10.0, 1.0) == \
        jtens.stability_dt(jcfg.grid, 0.5, 10.0, 1.0)
    assert ttens.stability_dt(grid, 0.0) == math.inf


# --- the 2D gates of tests/test_vof.py on the port ------------------------------------

def _circle(level):
    return tvof.fraction_from_levelset(TGrid(level=level), _circle_t,
                                       device="cpu")


def test_line_geometry_roundtrip():
    rng = np.random.default_rng(0)
    m1 = _t(rng.uniform(0, 1, 2000))
    m2 = 1.0 - m1
    c = _t(rng.uniform(0, 1, 2000))
    a = tvof.line_alpha_positive(m1, m2, c)
    assert float(torch.max(torch.abs(tvof.line_area_positive(m1, m2, a)
                                     - c))) < 1e-12


def test_rectangle_fraction_consistency():
    """The whole-cell rectangle is line_area; the halves sum to it."""
    rng = np.random.default_rng(1)
    m1 = _t(rng.uniform(0.05, 0.95, 500))
    m2 = 1.0 - m1
    a = _t(rng.uniform(0, 1, 500))
    zero, half, one = (torch.full_like(a, v) for v in (0.0, 0.5, 1.0))
    whole = tvof.line_area_positive(m1, m2, a)
    again = tvof.rectangle_fraction(m1, m2, a, zero, one, zero, one)
    left = tvof.rectangle_fraction(m1, m2, a, zero, half, zero, one)
    right = tvof.rectangle_fraction(m1, m2, a, half, one, zero, one)
    assert float(torch.max(torch.abs(again - whole))) < 1e-12
    assert float(torch.max(torch.abs(0.5 * (left + right) - whole))) < 1e-12


def test_normals_linear_interface():
    grid = TGrid(level=6)
    f = tvof.fraction_from_levelset(grid, lambda x, y: 0.2 - y, device="cpu")
    mx, my = tvof.normals(f, grid, tbc.default_scalar_bc(2))
    ifc = (f > 0.01) & (f < 0.99)
    assert float(torch.max(torch.abs(torch.where(ifc, mx, 0.0)))) < 1e-12
    assert float(torch.min(torch.where(ifc, my, 1.0))) == pytest.approx(1.0)


def test_init_fraction_volume():
    grid = TGrid(level=6)
    vol = float(_circle(6).sum()) * grid.h ** 2
    assert abs(vol - math.pi * R * R) / (math.pi * R * R) < 2e-3


def _wrap(a):
    return torch.remainder(a + 0.5, 1.0) - 0.5


def test_advection_translation():
    """Uniform translation: exact mass conservation, small shape error
    (the reference's test/advection)."""
    grid = TGrid(level=7)
    per = tbc.FieldBC.uniform(tbc.Periodic(), 2)
    f0 = _circle(7)
    uf = [torch.full(grid.face_shape(0), 1.0, dtype=torch.float64),
          torch.full(grid.face_shape(1), 0.5, dtype=torch.float64)]
    dt = 0.45 * grid.h
    nst = int(round(0.5 / dt))
    f = f0
    for i in range(nst):
        f = tvof.advect(f, uf, grid, per, dt, cstart=i % 2)
    tend = nst * dt
    fe = tvof.fraction_from_levelset(
        grid, lambda x, y: R * R - _wrap(x - 1.0 * tend) ** 2
        - _wrap(y - 0.5 * tend) ** 2, device="cpu")
    mass_drift = abs(float(f.sum() - f0.sum())) / float(f0.sum())
    shape_err = float(torch.abs(f - fe).sum()) * grid.h ** 2
    assert mass_drift < 1e-12
    assert shape_err < 5e-4


def test_rotation_shape():
    """Solid-body rotation of a circle: shape kept after a half turn (the
    reference's test/rotate)."""
    grid = TGrid(level=7)
    per = tbc.FieldBC.uniform(tbc.Periodic(), 2)
    f0 = tvof.fraction_from_levelset(
        grid, lambda x, y: 0.15 ** 2 - (x - 0.2) ** 2 - y ** 2, device="cpu")
    omega = 2 * math.pi
    yf0 = _t(np.broadcast_to(grid.axis_centers(1)[None, :],
                             grid.face_shape(0)))
    xf1 = _t(np.broadcast_to(grid.axis_centers(0)[:, None],
                             grid.face_shape(1)))
    uf = [-omega * yf0, omega * xf1]
    dt = 0.45 * grid.h / (omega * 0.5 * math.sqrt(2))
    nst = int(round(0.5 / dt))
    dt = 0.5 / nst
    f = f0
    for i in range(nst):
        f = tvof.advect(f, uf, grid, per, dt, cstart=i % 2)
    fe = tvof.fraction_from_levelset(
        grid, lambda x, y: 0.15 ** 2 - (x + 0.2) ** 2 - y ** 2, device="cpu")
    shape_err = float(torch.abs(f - fe).sum()) * grid.h ** 2
    mass_drift = abs(float(f.sum() - f0.sum())) / float(f0.sum())
    assert mass_drift < 1e-10
    assert shape_err < 1.5e-3


def test_curvature_circle():
    """HF curvature of a circle: mean within 3% and every cell within 35%
    of 1/R at levels 6 and 7."""
    for lev in (6, 7):
        grid = TGrid(level=lev)
        k = tvof.curvature(_circle(lev), grid, tbc.default_scalar_bc(2))
        kv = k[torch.isfinite(k)].numpy()
        assert kv.size > 0
        assert abs(float(np.mean(kv)) * R - 1.0) < 0.03
        assert float(np.max(np.abs(kv * R - 1.0))) < 0.35


def test_vof_refusals():
    grid3 = TGrid(level=3, dim=3)
    with pytest.raises(NotImplementedError):
        tvof.fraction_from_levelset(grid3, lambda x, y: x, device="cpu")
    with pytest.raises(NotImplementedError):
        tbc.BC("contact", 90.0)
