"""The rising bubble (Hysing et al., Int. J. Numer. Meth. Fluids 60
(2009) 1259-1288, test case 1) of the port against ``gerris_tpu`` on the
CPU in float64: a variable viscosity, a body force and a non-square
two-phase box.

The configuration: the box [0, 1] x [0, 2] (``extents=(1, 2)``), one VOF
tracer T (1 in the liquid), density ("T", 1000, 100, 1), the dynamic
viscosity mu(T1) = 10 T1 + (1 - T1) of the filtered fraction
(``nu_var``, as MU(T1) in the reference's test/capwave/air-water),
gravity (None, -0.98), tension 24.5, the bubble of radius 0.25 at (0.5,
0.5), no-slip bottom and top walls and free-slip side walls.  The port
takes it through ``config_from_jax`` with torch counterparts of the
callables, which gives the TPU's floored schedule (nrelax 8, 16 coarsest
sweeps): the JAX side states those params explicitly, so both run the
same sweeps.  The JAX steps run eagerly (``jax.disable_jit``) so that
each solve's niter can be read."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.solvers import diffusion as jdiff  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.solvers import diffusion as tdiff  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            grid_from_jax, state_from_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-9
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
FLOOR = dict(nrelax=8, coarsest_relax=16)


def mu_jax(x, y, t=0.0, T1=None):
    return 10.0 * T1 + 1.0 * (1.0 - T1)


def mu_torch(x, y, t=0.0, T1=None):
    return 10.0 * T1 + 1.0 * (1.0 - T1)


def bubble_jcfg(level, extents=(1, 2), body_force=(None, -0.98)):
    """Hysing test case 1 as a JAX NSConfig at ``level`` (the reference's
    defaults: adaptive projections and diffusion)."""
    d0 = jbc.Dirichlet(0.0)
    u_bc = jbc.FieldBC.make(2, left=d0, right=d0, bottom=d0, top=d0)
    v_bc = jbc.FieldBC.make(2, left=jbc.Neumann(), right=jbc.Neumann(),
                            bottom=d0, top=d0)
    return jns.NSConfig(
        grid=JGrid(level=level, dim=2, origin=(0.0, 0.0), extents=extents),
        u_bcs=(u_bc, v_bc), nu=0.0, beta=1.0,
        vof_tracers=(("T", jbc.default_scalar_bc(2)),),
        tension=(("T", 24.5),), density=("T", 1000.0, 100.0, 1),
        body_force=body_force, nu_var=mu_jax,
        nu_var_fields=(("T1", "T", 1),))


def _floored(jcfg):
    """The JAX config on the schedule that config_from_jax gives the
    port."""
    mp = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100, **FLOOR)
    return dataclasses.replace(
        jcfg, projection=mp, approx_projection=mp,
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-3,
                                                   nitermax=10, **FLOOR))


def _configs(level, **kw):
    jcfg = bubble_jcfg(level, **kw)
    return _floored(jcfg), config_from_jax(jcfg, nu_var=mu_torch)


def _bubble_T(grid):
    return np.asarray(jvof.fraction_from_levelset(
        grid, lambda x, y: jnp.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - 0.25))


def _state(grid, seed, amp=0.01):
    rng = np.random.default_rng(seed)
    st = {n: amp * rng.standard_normal(grid.shape) for n in NAMES}
    st["T"] = _bubble_T(grid)
    return st


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _record(monkeypatch, module):
    """Every solve's niter, in call order."""
    rec = []
    real = module.solve

    def spy(*args, **kw):
        out = real(*args, **kw)
        rec.append(int(out[1].niter))
        return out

    monkeypatch.setattr(module, "solve", spy)
    return rec


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_step_cache():
    """Drop this module's compiled JAX steps when it ends: other files on
    the same test worker count ns_step's jit cache entries
    (tests/test_rigid.py)."""
    yield
    jns.ns_step.clear_cache()


def test_config_carries_the_bubble():
    jcfg, tcfg = _configs(5)
    assert tcfg.grid.shape == (32, 64) and tcfg.grid.extents == (1, 2)
    assert tcfg.body_force == (None, -0.98)
    assert tcfg.nu_var is mu_torch and tcfg.nu == 0.0
    assert tcfg.nu_var_fields == (("T1", "T", 1),)
    for p in (tcfg.projection, tcfg.approx_projection, tcfg.diffusion_params):
        assert (p.nrelax, p.coarsest_relax) == (8, 16)


@pytest.mark.parametrize("field", ["nu_var", "body_force"])
def test_config_from_jax_wants_torch_counterparts(field):
    """A JAX callable cannot be carried over: without its torch
    counterpart config_from_jax raises, naming the field; with it the
    counterpart is taken.  Constant force components carry over."""
    jcfg = bubble_jcfg(5, body_force=(None, lambda x, y, t=0.0: -0.98 + 0 * x))
    kw = dict(nu_var=mu_torch,
              body_force=(None, lambda x, y, t=0.0: -0.98 + 0 * x))
    with pytest.raises(NotImplementedError, match=field):
        config_from_jax(jcfg, **{k: v for k, v in kw.items() if k != field})
    got = config_from_jax(jcfg, **kw)
    assert got.nu_var is kw["nu_var"]
    assert got.body_force[0] is None and got.body_force[1] is kw["body_force"][1]


def test_viscosity_and_transpose_sources_match_jax():
    """viscosity_field (mu of the filtered fraction) and the explicit
    transpose-stress sources (1/rho) sum_j (d_c u_j)(d_j mu) on random
    velocities at 32 x 64, against gerris_tpu, within 1e-12 of max."""
    jcfg, tcfg = _configs(5)
    st = _state(jcfg.grid, seed=3, amp=1.0)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = state_from_numpy(st, device="cpu")
    jmu = jns.viscosity_field(js, jcfg, 0.0)
    tmu = tns.viscosity_field(ts, tcfg, 0.0)
    assert _rel(jmu, tmu) <= 1e-12
    jrho, _ = jns.density_fields(js, jcfg, 0.0)
    trho, _ = tns.density_fields(ts, tcfg, 0.0)
    U = [js["U"], js["V"]]
    jsrc = jns.viscous_transpose_sources(U, jmu, jcfg.grid, jcfg,
                                         1.0 / jrho, 0.0)
    tsrc = tns.viscous_transpose_sources([ts["U"], ts["V"]], tmu, tcfg.grid,
                                         tcfg, 1.0 / trho, 0.0)
    for a, b in zip(jsrc, tsrc):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_diffuse_face_D_matches_jax(beta):
    """diffuse with face-valued D (positive random faces) and a cell rho, its default adaptive schedule, the beta <
    1 explicit term div(D grad v), on a 32 x 64 box with the bubble's U
    BCs: the same niter and v within 1e-12 of max."""
    jcfg, tcfg = _configs(5)
    grid = jcfg.grid
    rng = np.random.default_rng(11)
    v = rng.standard_normal(grid.shape)
    rho = 100.0 + 900.0 * rng.random(grid.shape)
    extra = rng.standard_normal(grid.shape)
    Dj = tuple(jnp.asarray(rng.random(grid.face_shape(a)) + 0.5)
               for a in range(2))
    Dt = tuple(torch.from_numpy(np.asarray(d)) for d in Dj)
    dt = 0.01
    jv, jst = jdiff.diffuse(jnp.asarray(v), grid, jcfg.u_bcs[0], dt, Dj,
                            rho=jnp.asarray(rho), beta=beta,
                            extra_rhs=jnp.asarray(extra))
    tv, tst = tdiff.diffuse(torch.from_numpy(v), tcfg.grid, tcfg.u_bcs[0],
                            dt, Dt, rho=torch.from_numpy(rho), beta=beta,
                            extra_rhs=torch.from_numpy(extra))
    assert int(jst.niter) == tst.niter
    assert _rel(jv, tv) <= 1e-12
    # diffuse_pair refuses a face-valued D, as the reference pairs none
    with pytest.raises(NotImplementedError):
        tdiff.diffuse_pair([tv, tv], tcfg.grid, list(tcfg.u_bcs), dt, Dt,
                           1.0, None, extra_rhss=[tv, tv])


def _jax_bubble_steps():
    """The JAX side of test_bubble_step_matches_jax: 3 eager steps, and
    every solve's niter."""
    jcfg, _ = _configs(5)
    js = {k: jnp.asarray(v) for k, v in _state(jcfg.grid, seed=0).items()}
    dt = 0.2 * jcfg.grid.h
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        for i in range(3):
            js = jns.ns_step(js, dt, i * dt, jcfg, cstart=i % 2,
                             first_step=i == 0)
    return {**{n: js[n] for n in ("U", "V", "T", "P")},
            "niter": np.asarray(rec)}


def test_bubble_step_matches_jax(monkeypatch):
    """3 steps of the bubble at level 5 (32 x 64) from a small random
    velocity (seeded numpy), dt = 0.2 h, the VOF sweeps' first direction
    rotated each step: U, V, T and mean-free P within 1e-9 of max, and the
    niter of every solve (2 projections and 2 diffusions per step),
    against the JAX package's eager run pinned by tools/jax_pins.py
    (bubble_steps)."""
    ref = jax_pins.load("bubble_steps")
    jcfg, tcfg = _configs(5)
    st = _state(jcfg.grid, seed=0)
    ts = state_from_numpy(st, device="cpu")
    dt = 0.2 * jcfg.grid.h
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    for i in range(3):
        ts = tns.ns_step(ts, dt, i * dt, tcfg, first_step=i == 0,
                         cstart=i % 2)
    assert len(trec) == 12 and trec == list(ref["niter"]), (trec, ref)
    for n in ("U", "V", "T"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
    # the bubble rose, and no kernel launched on the CPU
    T = ts["T"].numpy()
    assert np.sum((1 - T) * st["V"]) != np.sum((1 - T) * ts["V"].numpy())
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def _column(level):
    """A resting two-density column under gravity in the unit box: T = 1
    (density 10) below y = -0.1, density 1 above, no-slip walls, no
    tension or viscosity, two fixed multigrid cycles per projection on
    the TPU's floored schedule.  Returns the JAX and the port's
    configs."""
    u_bc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    jcfg = jns.NSConfig(
        grid=JGrid(level=level), u_bcs=(u_bc, u_bc), nu=0.0,
        projection=jpoisson.MultilevelParams(ncycles=2, minlevel=3),
        approx_projection=jpoisson.MultilevelParams(ncycles=2, minlevel=3),
        vof_tracers=(("T", jbc.default_scalar_bc(2)),),
        density=("T", 10.0, 1.0, 1), body_force=(None, -1.0))
    # the fixed schedule's TPU floors, which config_from_jax applies
    mp = jpoisson.MultilevelParams(ncycles=2, minlevel=3, nrelax=8,
                                   coarsest_relax=40)
    return (dataclasses.replace(jcfg, projection=mp, approx_projection=mp),
            config_from_jax(jcfg))


def _line_area_piecewise(m1, m2, alpha):
    """jnp's line area in the port's piecewise form (gerris_tpu_torch
    physics/vof.py:line_area_positive): the intended function, which the
    reference's closed form (gerris_tpu vof.py:41-53) computes with a
    loss of ~eps / min(m1, m2) (ROADMAP Queue 3)."""
    a = jnp.clip(alpha, 0.0, 1.0)
    m1s, m2s = jnp.maximum(m1, jvof.EPS), jnp.maximum(m2, jvof.EPS)
    lo, hi = jnp.minimum(m1s, m2s), jnp.maximum(m1s, m2s)
    d = 2.0 * lo * hi
    v = jnp.where(a <= lo, a * a / d,
                  jnp.where(a <= hi, (a - 0.5 * lo) / hi,
                            1.0 - (1.0 - a) ** 2 / d))
    v = jnp.where(m1 < jvof.EPS, jnp.clip(a / m2s, 0.0, 1.0), v)
    v = jnp.where(m2 < jvof.EPS, jnp.clip(a / m1s, 0.0, 1.0), v)
    return jnp.clip(v, 0.0, 1.0)


def _column_state(grid):
    _, y = grid.centers
    st = {n: np.zeros(grid.shape) for n in NAMES}
    st["T"] = (np.asarray(y) < -0.1).astype(float)
    return st


def _jax_column():
    """The JAX side of test_hydrostatic_column_stays_at_rest: 10 eager
    steps of the resting column at 16^2, its line area the piecewise
    form."""
    real = jvof.line_area_positive
    jvof.line_area_positive = _line_area_piecewise
    try:
        jcfg, _ = _column(4)
        grid = jcfg.grid
        js = {k: jnp.asarray(v) for k, v in _column_state(grid).items()}
        dt = 0.5 * grid.h
        with jax.disable_jit():
            for i in range(10):
                js = jns.ns_step(js, dt, i * dt, jcfg, cstart=i % 2,
                                 first_step=i == 0)
    finally:
        jvof.line_area_positive = real
    return {n: js[n] for n in ("U", "V")}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"bubble_column": _jax_column, "bubble_steps": _jax_bubble_steps}


def test_hydrostatic_column_stays_at_rest():
    """The body force enters as a face source beside tension, so a
    hydrostatic state stays at rest: 10 steps of the resting column at
    16^2 (the JAX step eagerly: jitted, its rounding differs and the
    interface's fractions amplify it), U and V of the port against
    gerris_tpu within 1e-12 absolute, both at rest to the two cycles'
    accuracy, and the pressure hydrostatic: flat across the rows and
    dp/dy = rho g in the liquid.  The resting interface's normals have
    components of ~1e-12, where the reference's closed-form line area
    loses digits that the port's piecewise form keeps (6e-12 of U after
    10 steps): the JAX side runs the piecewise form, the intended
    function, for this test (_line_area_piecewise).  The JAX side's
    values are pinned (tools/jax_pins.py, bubble_column)."""
    ref = jax_pins.load("bubble_column")
    _, tcfg = _column(4)
    grid = tcfg.grid
    ts = state_from_numpy(_column_state(grid), device="cpu")
    dt = 0.5 * grid.h
    for i in range(10):
        ts = tns.ns_step(ts, dt, i * dt, tcfg, first_step=i == 0,
                         cstart=i % 2)
    for n in ("U", "V"):
        err = float(np.max(np.abs(ref[n] - ts[n].numpy())))
        assert err <= 1e-12, (n, err)
        # far below the free fall's g t = 0.31
        assert float(ts[n].abs().max()) <= 1e-5, n
    p = ts["P"].numpy()
    assert float(np.max(np.abs(p - p[:1]))) <= 1e-4
    assert np.diff(p[8, :4]).mean() == pytest.approx(-10.0 * grid.h,
                                                     rel=1e-3)


def test_timescale_with_body_force():
    """timescale: h / max|u| and the body-force bound sqrt(2 h / max|a|),
    a callable force at t = 0, against gerris_tpu."""
    grid = JGrid(level=5, dim=2, origin=(0.0, 0.0), extents=(1, 2))
    st = _state(grid, seed=5, amp=0.1)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = state_from_numpy(st, device="cpu")
    got = []
    for bf_j, bf_t in (((None, -0.98), (None, -0.98)),
                       ((None, -1e3), (None, -1e3)),
                       ((lambda x, y, t=0.0: 3.0 * x, None),
                        (lambda x, y, t=0.0: 3.0 * x, None))):
        jcfg = bubble_jcfg(5, body_force=bf_j)
        tcfg = dataclasses.replace(
            config_from_jax(jcfg, nu_var=mu_torch, body_force=bf_t),
            body_force=bf_t)
        got.append(float(tns.timescale(ts, tcfg)))
        assert got[-1] == pytest.approx(float(jns.timescale(js, jcfg)),
                                        rel=1e-14)
    # a strong force's bound is below the velocities' h / max|u|
    assert got[1] == pytest.approx(np.sqrt(2.0 * grid.h / 1e3), rel=1e-14)
    assert got[1] < got[0]


def test_body_force_absent_only_on_prescribed_normal_faces():
    """The reference's fault (gerris_tpu/models/ns.py:872-881, ROADMAP
    Queue 3): it zeroes the force on every non-periodic boundary face.
    With an outflow top (V Neumann: the normal velocity is not
    prescribed there) gravity still acts on the fluid at the top faces,
    so the port keeps the force on them and drops it only on the
    Dirichlet bottom faces.  On walls (the bubble's) the two agree."""
    grid = JGrid(level=3)
    v_out = tbc.FieldBC.make(2, left=tbc.Neumann(), right=tbc.Neumann(),
                             bottom=tbc.Dirichlet(0.0), top=tbc.Neumann())
    u_bc = tbc.FieldBC.uniform(tbc.Dirichlet(0.0), 2)
    cfg = tns.NSConfig(grid=grid_from_jax(grid), u_bcs=(u_bc, v_out),
                       body_force=(0.5, -2.0))
    like = torch.zeros(grid.shape, dtype=torch.float64)
    fx, fy = tns.body_force_sources(cfg, like)
    assert fy.shape == (8, 9) and fx.shape == (9, 8)
    assert torch.all(fy[:, 0] == 0.0) and torch.all(fy[:, 1:] == -2.0)
    assert torch.all(fx[0] == 0.0) and torch.all(fx[-1] == 0.0)
    assert torch.all(fx[1:-1] == 0.5)
    # a callable force at time t, at the faces' centres
    cfg_t = tns.NSConfig(grid=grid_from_jax(grid), u_bcs=(u_bc, v_out),
                         body_force=(None, lambda x, y, t=0.0: y * t + x))
    _, fy = tns.body_force_sources(cfg_t, like, t=2.0)
    x = torch.as_tensor(grid.axis_centers(0))[:, None]
    y = torch.as_tensor(grid.axis_faces(1))[None, :]
    assert torch.equal(fy[:, 1:], (y * 2.0 + x)[:, 1:])
    assert torch.all(fy[:, 0] == 0.0)
    # the bubble's walls: the port's faces are the reference's
    jcfg, tcfg = _configs(4)
    fx, fy = tns.body_force_sources(tcfg, torch.zeros(tcfg.grid.shape,
                                                      dtype=torch.float64))
    assert torch.all(fx == 0.0)
    assert torch.all(fy[:, 1:-1] == -0.98) and torch.all(fy[:, 0] == 0.0) \
        and torch.all(fy[:, -1] == 0.0)
