"""The port's 3D path against gerris_tpu on the CPU (float64): the grid,
BCs and stencils, the 3D multigrid pieces (residual, restriction,
trilinear prolongation, the dense coarsest solve, one cycle, the adaptive
solve) with Dirichlet, Neumann and periodic sides, the corrector
advection's ghost padding, and the NS step: the bench's 3D lid cavity
(bench.py:279-294) converted with ``config_from_jax``, and the default
adaptive schedule; then the port of tests/test_ns3d.py's Taylor-Green
decay through ``Simulation`` on the port alone.

The JAX CPU path caps the dense coarsest solve at 1024 unknowns, where
the TPU and the port take ``dense_coarse_max`` as given (4096, a 16^3
level): both sides are given ``dense_coarse_max=512`` (dense at 8^3).
Gates: 1e-12 of max|ref| for the pieces, equal cycle counts and 1e-10
per solve, 1e-9 of max|ref| over the steps."""
import dataclasses
import functools
import math
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
from gerris_tpu.ops import stencils as jst  # noqa: E402
from gerris_tpu.solvers import advection as jadv  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops import stencils as tst  # noqa: E402
from gerris_tpu_torch.solvers import advection as tadv  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

from test_torch_convert import bench_3d_cfg  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

NAMES = ("U", "V", "W", "P", "Pmac", "Gx", "Gy", "Gz")
DENSE = 512
PIECES = 1e-12
SOLVE = 1e-10
STEP = 1e-9


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


def _rnd(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


# BCs per kind: the residual and the padding read the values; the solves
# take homogeneous Neumann (zero-mean rhs) and periodic (zero-mean rhs)
KINDS = {
    "dirichlet": jbc.FieldBC(((jbc.Dirichlet(0.3), jbc.Dirichlet(-0.2)),
                              (jbc.Dirichlet(0.0), jbc.Dirichlet(1.0)),
                              (jbc.Dirichlet(0.5), jbc.Dirichlet(0.0)))),
    "neumann": jbc.FieldBC.uniform(jbc.Neumann(), 3),
    "periodic": jbc.FieldBC(((jbc.Periodic(), jbc.Periodic()),
                             (jbc.Dirichlet(0.0), jbc.Neumann()),
                             (jbc.Periodic(), jbc.Periodic()))),
}
VALUED = {**KINDS,
          "neumann": jbc.FieldBC(((jbc.Neumann(0.25), jbc.Neumann(-0.5)),
                                  (jbc.Neumann(), jbc.Neumann(0.75)),
                                  (jbc.Neumann(1.0), jbc.Neumann())))}


def _system(kind, level, seed=4):
    """(fbc, u, rhs, dia) at 2^level per side: a Helmholtz system on the
    Dirichlet box (dia = 1/(dt nu) at dt = 0.8 h), zero-mean rhs
    elsewhere."""
    shape = (1 << level,) * 3
    u, rhs = _rnd(seed, shape, shape)
    if kind == "dirichlet":
        return KINDS[kind], 0.1 * u, rhs, 1.0 / (0.8 / (1 << level) * 1e-3)
    return KINDS[kind], 0.1 * u, rhs - rhs.mean(), None


def test_grid_bc_stencils_3d():
    jg, tg = JGrid(level=3, dim=3), TGrid(level=3, dim=3)
    assert tg.shape == jg.shape == (8, 8, 8)
    assert all(tg.face_shape(a) == jg.face_shape(a) for a in range(3))
    for a, b in zip(jg.centers, tg.centers):
        assert np.array_equal(np.asarray(a), b)
    fbc = tbc.FieldBC.make(3, default=tbc.Dirichlet(0.0),
                           top=tbc.Dirichlet(1.0), front=tbc.Neumann(0.5))
    assert fbc.sides[1][1] == tbc.Dirichlet(1.0)
    assert fbc.sides[2] == (tbc.Dirichlet(0.0), tbc.Neumann(0.5))
    (u,) = _rnd(1, tg.shape)
    for kind, jfbc in VALUED.items():
        t = convert.fieldbc_from_jax(jfbc)
        for width in (1, 2):
            for corners in (False, True):
                ref = jbc.apply_bc(jnp.asarray(u), jg, jfbc, width,
                                   corners=corners)
                got = tbc.apply_bc(_t(u), tg, t, width, corners=corners)
                assert np.array_equal(np.asarray(ref), got.numpy()), \
                    (kind, width, corners)
        pad = tbc.apply_bc(_t(u), tg, t, 1, corners=False)
        jpad = jnp.asarray(pad.numpy())
        assert _rel(jst.laplacian(jpad, jg), tst.laplacian(pad, tg)) \
            <= PIECES
        for a in range(3):
            ref = jst.face_gradient(jpad, jg, a)
            assert _rel(ref, tst.face_gradient(pad, tg, a)) <= PIECES
            ref = jbc.apply_face_bc(jst.face_average(jpad, jg, a), jg, jfbc,
                                    a)
            got = tbc.apply_face_bc(tst.face_average(pad, tg, a), tg, t, a)
            assert _rel(ref, got) <= PIECES
    faces = _rnd(2, *(tg.face_shape(a) for a in range(3)))
    assert _rel(jst.divergence([jnp.asarray(f) for f in faces], jg),
                tst.divergence([_t(f) for f in faces], tg)) <= PIECES


@pytest.mark.parametrize("kind", list(VALUED))
def test_residual_restrict_prolong_3d(kind):
    """The residual with the BCs' values (static offsets), homogeneous,
    and through the padded route of a callable value; the 2x2x2
    restriction; the trilinear prolongation from 8^3 to 16^3."""
    jfbc, tfbc = VALUED[kind], convert.fieldbc_from_jax(VALUED[kind])
    jg, tg = JGrid(level=4, dim=3), TGrid(level=4, dim=3)
    u, rhs = _rnd(7, jg.shape, jg.shape)
    for hom in (False, True):
        ref = jpoisson.residual(jnp.asarray(u), jnp.asarray(rhs), jg, jfbc,
                                dia=0.6, homogeneous=hom)
        got = tpoisson.residual(_t(u), _t(rhs), tg, tfbc, dia=0.6,
                                homogeneous=hom)
        assert _rel(ref, got) <= PIECES
    assert _rel(jpoisson.restrict(jnp.asarray(u), 3),
                tpoisson.restrict(_t(u))) <= PIECES
    (c,) = _rnd(8, (8, 8, 8))
    ref = jpoisson.prolong(jnp.asarray(c), JGrid(level=3, dim=3), jfbc)
    assert _rel(ref, tpoisson.prolong(_t(c), tfbc, TGrid(level=3, dim=3))) \
        <= PIECES
    if kind == "dirichlet":
        jcb = jbc.FieldBC.make(3, top=jbc.Dirichlet(lambda x, y, z: x * z))
        tcb = tbc.FieldBC.make(3, top=tbc.Dirichlet(lambda x, y, z: x * z))
        ref = jpoisson.residual(jnp.asarray(u), jnp.asarray(rhs), jg, jcb)
        assert _rel(ref, tpoisson.residual(_t(u), _t(rhs), tg, tcb)) \
            <= PIECES


@pytest.mark.parametrize("kind", list(KINDS))
def test_dense_solve_cycle_3d(kind):
    """The dense coarsest solve (a whole 8^3 level: its 512 x 512
    Laplacian eigendecomposed) and one cycle at 16^3 (restrict to 8^3,
    dense, prolong + relax: K13's plain version on walls, the torch route
    on periodic sides), nrelax 3 at omega 1.3."""
    params = dict(nrelax=3, omega=1.3, dense_coarse_max=DENSE)
    jp, tp = (jpoisson.MultilevelParams(**params),
              tpoisson.MultilevelParams(**params))
    jfbc, u, rhs, dia = _system(kind, 3)
    tfbc = convert.fieldbc_from_jax(jfbc)
    ref = jpoisson.correction(jnp.asarray(rhs), JGrid(level=3, dim=3), jfbc,
                              jp, dia=dia)
    got = tpoisson.correction(_t(rhs), TGrid(level=3, dim=3), tfbc, tp,
                              dia=dia)
    assert _rel(ref, got) <= PIECES
    jfbc, u, rhs, dia = _system(kind, 4)
    ref = jpoisson.cycle(jnp.asarray(u), jnp.asarray(rhs),
                         JGrid(level=4, dim=3), jfbc, jp, dia=dia)
    got = tpoisson.cycle(_t(u), _t(rhs), TGrid(level=4, dim=3), tfbc, tp,
                         dia=dia)
    assert _rel(ref, got) <= PIECES


@pytest.mark.parametrize("kind", list(KINDS))
def test_adaptive_solve_3d(kind):
    """The adaptive loop to tolerance 1e-8 at 16^3: the same cycle count
    and u to 1e-10 of max|u| (the JAX side eagerly, jax.disable_jit)."""
    params = dict(tolerance=1e-8, dense_coarse_max=DENSE)
    jfbc, u, rhs, dia = _system(kind, 4)
    with jax.disable_jit():
        ju, jst_ = jpoisson.solve(jnp.asarray(u), jnp.asarray(rhs),
                                  JGrid(level=4, dim=3), jfbc,
                                  jpoisson.MultilevelParams(**params),
                                  dia=dia)
    tu, tst_ = tpoisson.solve(_t(u), _t(rhs), TGrid(level=4, dim=3),
                              convert.fieldbc_from_jax(jfbc),
                              tpoisson.MultilevelParams(**params), dia=dia)
    assert int(jst_.niter) == tst_.niter > 1
    assert _rel(ju, tu) <= SOLVE
    assert float(tst_.residual_after["infty"]) <= 1e-8 * np.abs(rhs).max()


def test_advection_pads_like_the_reference_3d(monkeypatch):
    """The 3D BCG face values pad v with corners=False, as the reference's
    generic route does: the values on the ghost ring next to an edge read
    the corner ghosts, which corners=True would build otherwise (Dirichlet
    0.5 and Neumann sides, so every padding differs there)."""
    jg, tg = JGrid(level=3, dim=3), TGrid(level=3, dim=3)
    jfbc = jbc.FieldBC(((jbc.Dirichlet(0.5), jbc.Neumann(0.25)),
                        (jbc.Neumann(-1.0), jbc.Dirichlet(0.5)),
                        (jbc.Dirichlet(0.5), jbc.Dirichlet(-0.5))))
    tfbc = convert.fieldbc_from_jax(jfbc)
    v, *uc = _rnd(11, (8, 8, 8), (10, 10, 10), (10, 10, 10), (10, 10, 10))
    dt = 0.8 * jg.h
    ref = jadv.advected_face_values(jnp.asarray(v), jg, jfbc, dt,
                                    jadv.AdvectionParams(),
                                    [jnp.asarray(a) for a in uc])
    got = tadv.advected_face_values(_t(v), tg, tfbc, dt, [_t(a) for a in uc])
    for (rp, rm), (gp, gm) in zip(ref, got):
        assert _rel(rp, gp) <= PIECES and _rel(rm, gm) <= PIECES
    apply_bc = tbc.apply_bc
    monkeypatch.setattr(tbc, "apply_bc",
                        lambda *a, corners=True, **k: apply_bc(*a, **k))
    other = tadv.advected_face_values(_t(v), tg, tfbc, dt,
                                      [_t(a) for a in uc])
    assert max(_rel(r[0], o[0]) for r, o in zip(ref, other)) > 1e-3


def _jax_steps(jcfg, state, steps, dt, init=False):
    """``steps`` JAX ns_steps (one compiled program), after its initial
    projection with ``init``."""
    js = {k: jnp.asarray(v) for k, v in state.items()}
    if init:
        js = jns.initial_projection(js, dt, 0.0, jcfg)
    step = jax.jit(lambda s: jns.ns_step(s, dt, 0.0, jcfg))
    for _ in range(steps):
        js = step(js)
    return js


def _port_steps(jcfg, state, steps, dt, init=False):
    """The same steps of the port on the converted config."""
    tcfg = convert.config_from_jax(jcfg)
    ts = {k: _t(v) for k, v in state.items()}
    if init:
        ts = tns.initial_projection(ts, dt, 0.0, tcfg)
    for _ in range(steps):
        ts = tns.ns_step(ts, dt, 0.0, tcfg)
    return ts


def _bench_case(level):
    jcfg = bench_3d_cfg(level, DENSE)
    shape = jcfg.grid.shape
    state = dict(zip(NAMES, (0.1 * a for a in _rnd(level, *[shape] * 8))))
    return jcfg, state


def _jax_bench(level, steps):
    """The JAX side of test_bench_3d_step_matches_jax."""
    jcfg, state = _bench_case(level)
    js = _jax_steps(jcfg, state, steps, 0.8 * jcfg.grid.h)
    return {k: js[k] for k in ("U", "V", "W", "P")}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {f"bench3d_{level}_{steps}": functools.partial(_jax_bench, level,
                                                          steps)
            for level, steps in ((4, 5), (5, 3))}


@pytest.mark.parametrize("level,steps", [(4, 5), (5, 3)])
def test_bench_3d_step_matches_jax(level, steps):
    """The bench's 3D lid cavity under its fixed schedule (1 cycle,
    nrelax 4 at omega 1.5 for the projections, 1 sweep for the diffusion;
    no TPU floor in 3D), from a random state at dt = 0.8 h, against the
    JAX package's jitted steps pinned by tools/jax_pins.py
    (bench3d_LEVEL_STEPS)."""
    ref = jax_pins.load(f"bench3d_{level}_{steps}")
    jcfg, state = _bench_case(level)
    ts = _port_steps(jcfg, state, steps, 0.8 * jcfg.grid.h)
    for k in ("U", "V", "W", "P"):
        assert _rel(ref[k], ts[k]) <= STEP, k


def _default_3d_case():
    grid = JGrid(level=4, dim=3)
    per = (jbc.Periodic(), jbc.Periodic())
    wall = (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0))
    ub = jbc.FieldBC((per, (wall[0], jbc.Dirichlet(1.0)), wall))
    vb = jbc.FieldBC((per, wall, wall))
    proj = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                     dense_coarse_max=DENSE)
    jcfg = jns.NSConfig(grid=grid, u_bcs=(ub, vb, vb), nu=1e-3,
                        projection=proj, approx_projection=proj,
                        diffusion_params=jpoisson.MultilevelParams(
                            tolerance=1e-3, nitermax=10,
                            dense_coarse_max=DENSE))
    state = dict(zip(NAMES, (0.1 * a for a in _rnd(16, *[grid.shape] * 8))))
    return jcfg, state


def _jax_default_3d():
    """The JAX side of test_default_3d_step_matches_jax."""
    jcfg, state = _default_3d_case()
    js = _jax_steps(jcfg, state, 2, 0.8 * jcfg.grid.h, init=True)
    return {k: js[k] for k in NAMES}


JAX_PINS["default3d"] = _jax_default_3d


def test_default_3d_step_matches_jax():
    """The default adaptive schedule (tolerance 1e-3, the diffusion's
    default) at 16^3 with a periodic x axis and lid walls: the initial
    projection and 2 steps, against the JAX package's steps pinned by
    tools/jax_pins.py (default3d)."""
    ref = jax_pins.load("default3d")
    jcfg, state = _default_3d_case()
    ts = _port_steps(jcfg, state, 2, 0.8 * jcfg.grid.h, init=True)
    for k in NAMES:
        assert _rel(ref[k], ts[k]) <= STEP, k


NU = 0.02
K = 2 * math.pi


def test_3d_taylor_green_decays():
    """tests/test_ns3d.py::test_3d_step_runs_and_decays on the port: the
    periodic 3D Taylor-Green field at 16^3 through Simulation on the CPU
    decays at 6 K^2 nu within 5%, finite (the default adaptive schedule,
    dense at 8^3 as on the JAX CPU path)."""
    grid = TGrid(level=4, dim=3)
    per = tbc.FieldBC.uniform(tbc.Periodic(), 3)
    mp = tpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                   dense_coarse_max=DENSE)
    cfg = tns.NSConfig(grid=grid, u_bcs=(per, per, per), nu=NU, beta=0.5,
                       projection=mp, approx_projection=mp,
                       diffusion_params=dataclasses.replace(mp, nitermax=10))
    x, y, z = grid.centers
    u = np.cos(K * x) * np.sin(K * y) * np.sin(K * z)
    v = -0.5 * np.sin(K * x) * np.cos(K * y) * np.sin(K * z)
    w = -0.5 * np.sin(K * x) * np.sin(K * y) * np.cos(K * z)
    sim = Simulation(cfg, time=Time(end=0.05, dtmax=0.5 * grid.h),
                     device="cpu").init(U=u, V=v, W=w)

    def energy():
        return float(sum((sim.state[n] ** 2).mean() for n in "UVW"))

    ke0 = energy()
    sim.run()
    ke1 = energy()
    assert 0.3 * ke0 < ke1 < ke0
    for n in ("U", "V", "W", "P"):
        assert bool(torch.isfinite(sim.state[n]).all())
    rate = -math.log(ke1 / ke0) / sim.time.t
    expect = 6 * K * K * NU
    assert abs(rate - expect) / expect < 0.05
