"""The port's adaptive-tolerance solve, its other branches and the default
NS step against gerris_tpu on the CPU (float64), and the port of
tests/test_poisson.py's gates on the port alone.

Both packages run one schedule: the JAX CPU path caps the dense coarse
solve at 1024 unknowns and applies no TPU floor, so the port is given
``dense_coarse_max=1024`` and a ``coarse_top`` at or above the fine level
(the JAX CPU path never takes K12; tests/test_torch_coarse.py holds that
route).  The JAX side runs eagerly (``jax.disable_jit``), which costs no
compile of its loops.  Gates: equal cycle counts and 1e-10 of max|u| per
solve; 1e-9 relative over 10 NS steps."""
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
from gerris_tpu.models.simulation import Simulation as JSimulation  # noqa: E402
from gerris_tpu.models.simulation import Time as JTime  # noqa: E402
from gerris_tpu.solvers import diffusion as jdiff  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg, rbgs  # noqa: E402
from gerris_tpu_torch.ops.stencils import norms, unbiased_error  # noqa: E402
from gerris_tpu_torch.solvers import diffusion as tdiff  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (fieldbc_from_jax,  # noqa: E402
                                            state_from_numpy)

NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")


sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / np.max(np.abs(ref)))


def _lid_bcs():
    u_bc = jbc.FieldBC.make(2, default=jbc.Dirichlet(0.0),
                            top=jbc.Dirichlet(1.0))
    v_bc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    return u_bc, v_bc


def _system(kind, level, seed=21):
    """(JAX fbc, u, rhs, dia, rhs_sub) of one of the step's systems at
    2^level: the lid pressure (Neumann, the compatibility mean as
    rhs_sub), the lid's U Helmholtz system (Dirichlet offsets, dia =
    1/(dt nu) at dt = 0.8 h, nu = 1e-3) and a doubly periodic one."""
    grid = JGrid(level=level)
    rng = np.random.default_rng(seed)
    u = 0.1 * rng.standard_normal(grid.shape)
    rhs = rng.standard_normal(grid.shape)
    if kind == "pressure":
        return jbc.default_scalar_bc(2), u, rhs, None, float(rhs.mean())
    if kind == "helmholtz":
        dia = 1.0 / (0.8 * grid.h * 1e-3)
        return _lid_bcs()[0], u, -dia * (u + 0.01 * rhs), dia, None
    return jbc.periodic_bc(2), u, rhs - rhs.mean(), None, None


def _solve_both(kind, level, jparams, tparams):
    fbc, u, rhs, dia, sub = _system(kind, level)
    with jax.disable_jit():
        ju, jst = jpoisson.solve(jnp.asarray(u), jnp.asarray(rhs),
                                 JGrid(level=level), fbc, jparams, dia=dia,
                                 rhs_sub=sub)
    tu, tst = tpoisson.solve(torch.from_numpy(u), torch.from_numpy(rhs),
                             TGrid(level=level), fieldbc_from_jax(fbc),
                             tparams, dia=dia, rhs_sub=sub)
    return ju, jst, tu, tst


KINDS = ["pressure", "helmholtz", "periodic"]


@pytest.mark.parametrize("level", [7, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_adaptive_solve_matches_jax(kind, level):
    """The adaptive loop (ncycles 0) to tolerance 1e-8 at 128^2 and
    256^2: the same cycle count and u to 1e-10 of max|u|."""
    jp = jpoisson.MultilevelParams(tolerance=1e-8, dense_coarse_max=1024,
                                   tpu_nrelax=1)
    tp = tpoisson.MultilevelParams(tolerance=1e-8, dense_coarse_max=1024,
                                   coarse_top=1 << level)
    ju, jst, tu, tst = _solve_both(kind, level, jp, tp)
    assert int(jst.niter) == tst.niter > 1
    assert _rel(ju, tu) <= 1e-10
    # one host read of the loop's condition per check
    assert tst.host_syncs == tst.niter


@pytest.mark.parametrize("kind,params", [
    ("pressure", dict(nitermin=3, nitermax=3)),
    ("helmholtz", dict(nitermin=2, nitermax=2, omega=1.3)),
    ("periodic", dict(ncycles=2)),
    ("periodic", dict(ncycles=2, nrelax=3, erelax=2, dense_coarse_max=0,
                      minlevel=4, coarsest_relax=20)),
])
def test_fixed_branches_match_jax(kind, params):
    """The host-looped nitermin == nitermax count, the non-fused fixed
    cycles on periodic rows, and the relax-coarsest branch (no dense
    solve, erelax 2) at 128^2, to 1e-10 of max|u|."""
    params = {"dense_coarse_max": 1024, **params}
    jp = jpoisson.MultilevelParams(**params)
    tp = tpoisson.MultilevelParams(coarse_top=128, **params)
    ju, jst, tu, tst = _solve_both(kind, 7, jp, tp)
    assert int(jst.niter) == tst.niter
    assert _rel(ju, tu) <= 1e-10


@pytest.mark.parametrize("kind", ["helmholtz", "periodic"])
def test_solve_relax_matches_jax(kind):
    """The "relax" registry solver (K11 -> K10 -> K11), taken before any
    multigrid branch, against the reference's solve_relax."""
    jp = jpoisson.MultilevelParams(solver="relax", nrelax=6, omega=1.2)
    tp = tpoisson.MultilevelParams(solver="relax", nrelax=6, omega=1.2)
    ju, jst, tu, tst = _solve_both(kind, 7, jp, tp)
    assert int(jst.niter) == tst.niter == 1
    assert _rel(ju, tu) <= 1e-10


def test_register_solver_seam():
    calls = []

    def mine(u, rhs, grid, fbc, params, dia, t):
        calls.append((params.solver, dia, t))
        return u, None

    tpoisson.register_solver("mine", mine)
    try:
        z = torch.zeros(8, 8, dtype=torch.float64)
        tpoisson.solve(z, z, TGrid(level=3), tbc.default_scalar_bc(2),
                       tpoisson.MultilevelParams(solver="mine"), dia=0.5,
                       t=0.25)
    finally:
        del tpoisson.SOLVER_REGISTRY["mine"]
    assert calls == [("mine", 0.5, 0.25)]


def test_params_defaults_are_the_reference_s():
    """MultilevelParams' fields and defaults are the reference's
    (gerris_tpu/solvers/poisson.py:40-89), adaptive by default; the port's
    default NSConfig and diffuse's default are the reference's too (they
    ran a fixed cycle before the adaptive slice)."""
    jd, td = jpoisson.MultilevelParams(), tpoisson.MultilevelParams()
    for f in dataclasses.fields(td):
        assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert td.ncycles == 0 and td.coarsest_relax == 8
    grid = TGrid(level=6)
    u_bc, v_bc = (fieldbc_from_jax(f) for f in _lid_bcs())
    cfg = tns.NSConfig(grid=grid, u_bcs=(u_bc, v_bc))
    jcfg = jns.NSConfig(grid=JGrid(level=6), u_bcs=_lid_bcs())
    for name in ("projection", "approx_projection"):
        for f in dataclasses.fields(td):
            assert getattr(getattr(cfg, name), f.name) == \
                getattr(getattr(jcfg, name), f.name), (name, f.name)
    assert cfg.diffusion_params is None and jcfg.diffusion_params is None
    assert tdiff.DEFAULT_PARAMS == tpoisson.MultilevelParams(tolerance=1e-3,
                                                             nitermax=10)
    assert not tns._pair_route(grid, dataclasses.replace(cfg, nu=1e-3))


# --- the NS step -----------------------------------------------------------------

def _ns_configs(level=6, diffusion=None):
    """The JAX default NSConfig of the lid cavity (nu 1e-3) and the port's,
    both on one schedule: the port's defaults with dense_coarse_max 1024,
    the JAX CPU cap.  ``diffusion``: both sides' diffusion_params."""
    u_bc, v_bc = _lid_bcs()
    jcfg = jns.NSConfig(grid=JGrid(level=level), u_bcs=(u_bc, v_bc),
                        nu=1e-3, diffusion_params=diffusion)
    tcfg = tns.NSConfig(grid=TGrid(level=level),
                        u_bcs=(fieldbc_from_jax(u_bc), fieldbc_from_jax(v_bc)),
                        nu=1e-3)
    cap = dict(dense_coarse_max=1024)
    tdp = tdiff.DEFAULT_PARAMS if diffusion is None else \
        tpoisson.MultilevelParams(**{f.name: getattr(diffusion, f.name)
                                     for f in dataclasses.fields(
                                         tpoisson.MultilevelParams)})
    tcfg = dataclasses.replace(
        tcfg, projection=dataclasses.replace(tcfg.projection, **cap),
        approx_projection=dataclasses.replace(tcfg.approx_projection, **cap),
        diffusion_params=dataclasses.replace(tdp, **cap))
    return jcfg, tcfg


DIFFUSIONS = [None, jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                             solver="relax")]


def _ns_state():
    rng = np.random.default_rng(3)
    return {n: 0.05 * rng.standard_normal((64, 64)) for n in NAMES}


def _jax_default_ns(k):
    """The JAX side of test_default_ns_step_matches_jax with DIFFUSIONS[k]:
    10 eager steps."""
    jcfg, _ = _ns_configs(diffusion=DIFFUSIONS[k])
    js = _ns_state()
    dt = 0.8 * jcfg.grid.h
    for i in range(10):
        with jax.disable_jit():
            js = jns.ns_step(js, dt, 0.0, jcfg, first_step=i == 0)
    return {n: js[n] for n in ("U", "V", "P")}


@pytest.mark.parametrize("diffusion", DIFFUSIONS)
def test_default_ns_step_matches_jax(diffusion):
    """10 lid steps at 64^2 from a small random state (seeded numpy),
    fixed dt = 0.8 h: the default NSConfig (adaptive projections, the
    adaptive diffusion per component), and the "relax" diffusion, against
    the JAX package's eager steps pinned by tools/jax_pins.py
    (adaptive_ns_0, adaptive_ns_1)."""
    ref = jax_pins.load(f"adaptive_ns_{DIFFUSIONS.index(diffusion)}")
    _, tcfg = _ns_configs(diffusion=diffusion)
    ts = state_from_numpy(_ns_state(), device="cpu")
    dt = 0.8 * tcfg.grid.h
    for i in range(10):
        ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=i == 0)
    for n in ("U", "V", "P"):
        assert _rel(ref[n], ts[n]) <= 1e-9, (n, _rel(ref[n], ts[n]))


class _JSim(JSimulation):
    """The JAX Simulation with the step's VOF sweep-direction argument left
    at its default (as tests/test_torch_ns.py)."""

    def _advance(self):
        self.state = jns.ns_step(self.state, self.dt, self.time.t, self.cfg,
                                 first_step=self.time.i == 0)


def _jax_default_simulation():
    """The JAX side of test_default_simulation_run_matches_jax: init + 5
    eager steps, and the time."""
    jcfg, _ = _ns_configs()
    with jax.disable_jit():
        jsim = _JSim(jcfg, time=JTime(end=300.0, dtmax=1.0)).init()
        jsim.run(max_steps=5)
    return {**{n: jsim.state[n] for n in ("U", "V", "P")},
            "i": jsim.time.i, "t": jsim.time.t}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"adaptive_simulation": _jax_default_simulation,
            **{f"adaptive_ns_{k}": functools.partial(_jax_default_ns, k)
               for k in range(len(DIFFUSIONS))}}


def test_default_simulation_run_matches_jax():
    """Simulation.init + run (initial projection, CFL timesteps) for 5
    steps with the default configuration against the JAX Simulation's,
    pinned by tools/jax_pins.py (adaptive_simulation); no kernel
    launches on the CPU."""
    ref = jax_pins.load("adaptive_simulation")
    _, tcfg = _ns_configs()
    tsim = Simulation(tcfg, time=Time(end=300.0, dtmax=1.0), device="cpu",
                      dtype=torch.float64).init()
    rbgs.reset_launch_counts()
    tsim.run(max_steps=5)
    assert tsim.time.i == int(ref["i"]) == 5
    assert abs(tsim.time.t - float(ref["t"])) <= 1e-12 * abs(float(ref["t"]))
    for n in ("U", "V", "P"):
        assert _rel(ref[n], tsim.state[n]) <= 1e-9, n
    assert all(v == 0 for v in rbgs.LAUNCHES.values()), rbgs.LAUNCHES


def test_diffuse_pair_adaptive_falls_back_like_jax():
    """diffuse_pair with an adaptive schedule solves each component with
    its own adaptive solve, as the reference's sequential fallback
    (gerris_tpu/solvers/diffusion.py:82-125)."""
    jgrid, tgrid = JGrid(level=6), TGrid(level=6)
    fbcs = list(_lid_bcs())
    dt, nu = 0.8 * jgrid.h, 1e-3
    rng = np.random.default_rng(5)
    vs = [0.1 * rng.standard_normal(jgrid.shape) for _ in range(2)]
    extra = [0.01 * rng.standard_normal(jgrid.shape) for _ in range(2)]
    with jax.disable_jit():
        ref, _ = jdiff.diffuse_pair([jnp.asarray(v) for v in vs], jgrid,
                                    fbcs, dt, nu, 1.0, None,
                                    extra_rhss=[jnp.asarray(e)
                                                for e in extra])
    params = dataclasses.replace(tdiff.DEFAULT_PARAMS, dense_coarse_max=1024)
    got, stats = tdiff.diffuse_pair(
        [torch.from_numpy(v) for v in vs], tgrid,
        [fieldbc_from_jax(f) for f in fbcs], dt, nu, 1.0, params,
        extra_rhss=[torch.from_numpy(e) for e in extra])
    for a, b in zip(ref, got):
        assert _rel(a, b) <= 1e-10
    assert stats.niter >= 1


# --- tests/test_poisson.py's gates, on the port alone --------------------------

K = 3


def _exact(x, y, t=0.0):
    return torch.sin(math.pi * K * x) * torch.sin(math.pi * K * y)


def _poisson_setup(level):
    """test/poisson/poisson.gfs: lap u = f on the unit box, Dirichlet u =
    sin(3 pi x) sin(3 pi y) on every side, given as a callable."""
    grid = TGrid(level=level)
    x, y = (torch.from_numpy(c) for c in grid.centers)
    rhs = -(math.pi ** 2) * 2 * K * K * _exact(x, y)
    fbc = tbc.FieldBC.uniform(tbc.Dirichlet(_exact), 2)
    return grid, rhs, fbc


# the reference's CPU schedule (MultilevelParams() with its 1024 cap)
CPU_PARAMS = dict(dense_coarse_max=1024)


def _poisson_solve(level, ncycles=10):
    grid, rhs, fbc = _poisson_setup(level)
    params = tpoisson.MultilevelParams(nitermin=ncycles, nitermax=ncycles,
                                       **CPU_PARAMS)
    u, stats = tpoisson.solve(torch.zeros(grid.shape, dtype=torch.float64),
                              rhs, grid, fbc, params)
    return grid, u, stats


def _error_norms(grid, u):
    x, y = (torch.from_numpy(c) for c in grid.centers)
    return {k: float(v) for k, v in
            norms(unbiased_error(u - _exact(x, y))).items()}


def test_poisson_residual_reduction_rate():
    """>= 10x residual reduction per cycle at level 8, averaged over 10
    cycles (test/poisson/res-7.ref: ~13.9)."""
    grid, rhs, fbc = _poisson_setup(8)
    params = tpoisson.MultilevelParams(**CPU_PARAMS)
    u = torch.zeros(grid.shape, dtype=torch.float64)
    res = [float(tpoisson.residual(u, rhs, grid, fbc).abs().max())]
    for _ in range(10):
        u = tpoisson.cycle(u, rhs, grid, fbc, params)
        res.append(float(tpoisson.residual(u, rhs, grid, fbc).abs().max()))
    avg = (res[0] / res[-1]) ** (1.0 / 10)
    assert avg >= 10.0, avg
    assert res[-1] / res[0] < 1e-10


def test_poisson_error_norms_level8():
    """test/poisson/error.ref:6: L1 5.430e-5, L2 6.849e-5, Linf 1.693e-4
    (unbiased), each within 5%."""
    grid, u, _ = _poisson_solve(8)
    n = _error_norms(grid, u)
    assert abs(n["first"] - 5.430e-05) / 5.430e-05 < 0.05, n
    assert abs(n["second"] - 6.849e-05) / 6.849e-05 < 0.05, n
    assert abs(n["infty"] - 1.693e-04) / 1.693e-04 < 0.05, n


def test_poisson_convergence_order():
    """test/poisson/order.ref: order ~2 in every norm over levels 3-8."""
    errs = []
    for level in range(3, 9):
        grid, u, _ = _poisson_solve(level)
        n = _error_norms(grid, u)
        errs.append((n["first"], n["second"], n["infty"]))
    orders = np.log2(np.asarray(errs[:-1]) / np.asarray(errs[1:]))
    assert np.all(orders[-3:] > 1.75) and np.all(orders[-3:] < 2.3), orders


def test_poisson_tolerance_loop():
    """The adaptive loop reaches tolerance 1e-9 in fewer than 15 cycles."""
    grid, rhs, fbc = _poisson_setup(6)
    params = tpoisson.MultilevelParams(tolerance=1e-9, nitermax=50,
                                       **CPU_PARAMS)
    u, stats = tpoisson.solve(torch.zeros(grid.shape, dtype=torch.float64),
                              rhs, grid, fbc, params)
    assert float(stats.residual_after["infty"]) <= \
        1e-9 * float(rhs.abs().max())
    assert stats.niter < 15


def test_callable_bc_residual_matches_jax():
    """apply_bc evaluates a callable value at the boundary face centres:
    the padded residual against the reference's, with a time-dependent
    Dirichlet side and a Neumann side."""
    jgrid, tgrid = JGrid(level=5), TGrid(level=5)

    def jval(x, y, t):
        return jnp.cos(x + 2.0 * y) * (1.0 + t)

    def tval(x, y, t):
        return torch.cos(x + 2.0 * y) * (1.0 + t)

    def jgrad(x, y):
        return x * y

    def tgrad(x, y):
        return x * y

    jf = jbc.FieldBC(((jbc.Dirichlet(jval), jbc.Neumann(jgrad)),
                      (jbc.Dirichlet(0.5), jbc.Dirichlet(jval))))
    tf = tbc.FieldBC(((tbc.Dirichlet(tval), tbc.Neumann(tgrad)),
                      (tbc.Dirichlet(0.5), tbc.Dirichlet(tval))))
    rng = np.random.default_rng(7)
    u, rhs = rng.standard_normal(jgrid.shape), rng.standard_normal(
        jgrid.shape)
    ref = jpoisson.residual(jnp.asarray(u), jnp.asarray(rhs), jgrid, jf,
                            dia=0.3, t=0.7)
    got = tpoisson.residual(torch.from_numpy(u), torch.from_numpy(rhs),
                            tgrid, tf, dia=0.3, t=0.7)
    assert _rel(ref, got) <= 1e-12
    assert not tbc.static_values(tf)
    # the kernels refuse callable values, as the reference's do; the
    # corners=False route evaluates them at t as the reference's does
    # (off the corner ghosts, which the reference leaves zero there)
    assert bcg.kernel_spec(tf) is None
    want = np.asarray(jbc.apply_bc(jnp.asarray(u), jgrid, jf, t=0.7,
                                   corners=False))
    pad = tbc.apply_bc(torch.from_numpy(u), tgrid, tf, corners=False,
                       t=0.7).numpy()
    for sl in ((slice(1, -1), slice(None)), (slice(None), slice(1, -1))):
        assert np.max(np.abs(pad[sl] - want[sl])) <= \
            1e-15 * np.max(np.abs(want))
