"""The two-phase step (VOF, height-function tension, variable density)
of the port against ``gerris_tpu`` on the CPU in float64.

The configuration is __graft_entry__._dryrun_twophase's: walls with
Dirichlet 0 velocities, nu 1e-3, beta 1, one VOF tracer T with the
default scalar BCs, tension 0.5, density ("T", 10, 1, 1), the default
adaptive projections and diffusion, T0 from the level set -(y - 0.01
cos 2 pi x).  The port takes it through ``config_from_jax``, which gives
the TPU's schedule: nrelax 8 and 16 coarsest sweeps for the projections
and the diffusion (the floors of gerris_tpu poisson.py:1139-1143).  The
JAX CPU path applies no floor, so its NSConfig states those params
explicitly, and both sides run the same sweeps.  The JAX step runs
eagerly (``jax.disable_jit``) so that each solve's niter can be read.
Tolerance: U, V, T and mean-free P within 1e-9 of max, equal niter per
solve.  The oscillation gate of tests/test_oscillation.py is ported at
the end (marked slow, as the reference's)."""
import dataclasses
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
from gerris_tpu.physics import tension as jtens  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.events.events import Event  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.physics import vof as tvof  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            state_from_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-9
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")


def twophase_cfg(level):
    """__graft_entry__._dryrun_twophase's NSConfig at ``level``."""
    tb = jbc.default_scalar_bc(2)
    u_bc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    return jns.NSConfig(grid=JGrid(level=level, dim=2), u_bcs=(u_bc, u_bc),
                        nu=1e-3, beta=1.0, vof_tracers=(("T", tb),),
                        tension=(("T", 0.5),), density=("T", 10.0, 1.0, 1))


def _configs(level):
    """(JAX config on the TPU's floored schedule, the port's from
    config_from_jax of the unfloored one)."""
    jcfg = twophase_cfg(level)
    tcfg = config_from_jax(jcfg)
    floor = dict(nrelax=8, coarsest_relax=16)
    jcfg = dataclasses.replace(
        jcfg,
        projection=dataclasses.replace(jcfg.projection, **floor),
        approx_projection=dataclasses.replace(jcfg.approx_projection,
                                              **floor),
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-3,
                                                   nitermax=10, **floor))
    return jcfg, tcfg


def _level_set_j(x, y):
    return -(y - 0.01 * jnp.cos(2 * jnp.pi * x))


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.cpu().numpy()
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


def test_config_converts_to_the_tpu_schedule():
    _, tcfg = _configs(6)
    for p in (tcfg.projection, tcfg.approx_projection):
        assert (p.nrelax, p.coarsest_relax, p.tolerance, p.nitermax) == \
            (8, 16, 1e-3, 100)
    d = tcfg.diffusion_params
    assert (d.nrelax, d.coarsest_relax, d.tolerance, d.nitermax) == \
        (8, 16, 1e-3, 10)
    assert tcfg.vof_tracers == (("T", tbc.default_scalar_bc(2)),)
    assert tcfg.tension == (("T", 0.5),)
    assert tcfg.density == ("T", 10.0, 1.0, 1)


@pytest.mark.parametrize("field,value", [
    ("particle_coupling", True),
    ("pack_faces", True),
])
def test_config_from_jax_refuses_slice_3b(field, value):
    """Outside the slices: refused, naming the field; particle_coupling
    carries over since slice 6."""
    jcfg = dataclasses.replace(twophase_cfg(5), **{field: value})
    if field == "particle_coupling":
        assert config_from_jax(jcfg).particle_coupling is value
        return
    with pytest.raises(NotImplementedError, match=field):
        config_from_jax(jcfg)


@pytest.mark.parametrize("field,value", [
    ("tension_css", (("T", 0.5),)),
    ("tracers", (("C", jbc.default_scalar_bc(2), 1e-3, 0.5),)),
])
def test_config_from_jax_carries_slice_3c(field, value):
    """The CSS tension and the tracers carry over (they were refused
    before slice 3c), and compute what gerris_tpu computes on the
    two-phase state at 32^2: the CSS sources, or one tracer advection
    (source and diffusion) with random faces."""
    jcfg, _ = _configs(5)
    jcfg = dataclasses.replace(jcfg, **{field: value})
    tcfg = dataclasses.replace(config_from_jax(jcfg),
                               diffusion_params=tpoisson.MultilevelParams(
                                   tolerance=1e-3, nitermax=10, nrelax=8,
                                   coarsest_relax=16))
    assert getattr(tcfg, field)[0][0] == value[0][0]
    st = _state(5)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = state_from_numpy(st, device="cpu")
    if field == "tension_css":
        assert tcfg.tension_css == (("T", 0.5),)
        jrho, _ = jns.density_fields(js, jcfg, 0.0)
        trho, _ = tns.density_fields(ts, tcfg, 0.0)
        ref = jtens.css_tension_sources(js["T"], 0.5, jcfg.grid,
                                        jbc.default_scalar_bc(2),
                                        alpha_cell=1.0 / jrho)
        got = tns.css_sources(ts, tcfg, trho)
    else:
        assert tcfg.tracers == (("C", tbc.default_scalar_bc(2), 1e-3, 0.5),)
        rng = np.random.default_rng(2)
        uf = [0.3 * rng.standard_normal(jcfg.grid.face_shape(c))
              for c in range(2)]
        C = rng.random(jcfg.grid.shape)
        ref = [jns.advect_tracer(jnp.asarray(C), jcfg.tracers[0],
                                 [jnp.asarray(u) for u in uf], jcfg.grid,
                                 jcfg, 0.01, 0.0)]
        got = [tns.advect_tracer(torch.from_numpy(C), tcfg.tracers[0],
                                 [torch.from_numpy(u) for u in uf],
                                 tcfg.grid, tcfg, 0.01)]
    for r, g in zip(ref, got):
        assert _rel(r, g) <= RTOL


def test_config_from_jax_refuses_contact():
    """Named for what it checked before slice 3c, when the contact kind
    was refused: now a contact angle carries over, a constant as it is
    and a JAX callable only through its torch counterpart (without one it
    is refused), and the port's contact-filled normals of the two-phase
    interface bent onto the bottom wall match gerris_tpu's."""
    contact = jbc.FieldBC(((jbc.Neumann(), jbc.Neumann()),
                           (jbc.Contact(60.0), jbc.Neumann())))
    jcfg = dataclasses.replace(twophase_cfg(5),
                               vof_tracers=(("T", contact),))
    tcfg = config_from_jax(jcfg)
    tfbc = tcfg.vof_tracers[0][1]
    assert tfbc.sides[1][0] == tbc.Contact(60.0)
    with pytest.raises(NotImplementedError, match="callable"):
        config_from_jax(dataclasses.replace(jcfg, vof_tracers=(
            ("T", jbc.FieldBC.make(2, bottom=jbc.Contact(
                lambda x, y, t: 60.0 + 0.0 * x))),)))
    got = config_from_jax(
        dataclasses.replace(jcfg, vof_tracers=(
            ("T", jbc.FieldBC.make(2, bottom=jbc.Contact(
                lambda x, y, t: 60.0 + 0.0 * x))),)),
        bc_values={"T": {(1, 0): lambda x, y, t: 60.0 + 0.0 * x}})
    assert callable(got.vof_tracers[0][1].sides[1][0].value)
    T = np.asarray(jvof.fraction_from_levelset(
        jcfg.grid, lambda x, y: 0.09 - ((x + 0.1) ** 2 + (y + 0.5) ** 2)))
    for r, g in zip(jvof.normals(jnp.asarray(T), jcfg.grid, contact),
                    tvof.normals(torch.from_numpy(T.copy()), tcfg.grid,
                                 tfbc)):
        assert _rel(r, g) <= 1e-13


def _state(level, seed=0):
    grid = JGrid(level=level)
    T0 = np.asarray(jvof.fraction_from_levelset(grid, _level_set_j))
    rng = np.random.default_rng(seed)
    st = {n: 0.01 * rng.standard_normal(grid.shape) for n in NAMES}
    st["T"] = T0
    return st


def _jax_twophase_steps():
    """The JAX side of test_twophase_step_matches_jax: 5 eager steps, and
    every solve's niter."""
    jcfg, _ = _configs(6)
    js = {k: jnp.asarray(v) for k, v in _state(6).items()}
    dt = 0.2 * jcfg.grid.h
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        for i in range(5):
            js = jns.ns_step(js, dt, 0.0, jcfg, cstart=i % 2,
                             first_step=i == 0)
    return {**{n: js[n] for n in ("U", "V", "T", "P")},
            "niter": np.asarray(rec)}


def test_twophase_step_matches_jax(monkeypatch):
    """5 two-phase steps at 64^2 from a small random velocity (seeded
    numpy) and the perturbed interface, dt = 0.2 h, the VOF sweeps'
    first direction rotated each step: U, V, T and mean-free P, and the
    niter of every solve (2 projections and 2 diffusions per step),
    against the JAX package's run pinned by tools/jax_pins.py
    (twophase_steps)."""
    ref = jax_pins.load("twophase_steps")
    _, tcfg = _configs(6)
    st = _state(6)
    ts = state_from_numpy(st, device="cpu")
    dt = 0.2 * tcfg.grid.h
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    for i in range(5):
        ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=i == 0,
                         cstart=i % 2)
    assert len(trec) == 20 and trec == list(ref["niter"]), (trec, ref)
    for n in ("U", "V", "T"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
    # the interface moved, and no kernel launched on the CPU
    assert not np.array_equal(ref["T"], st["T"])
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def test_twophase_step_runs_k15_at_every_level(monkeypatch):
    """Every solve of the step has face coefficients (1/rho for the
    projections, dt nu for the diffusion), so every correction relaxes
    each of the level - minlevel + 1 levels once through K15's wrapper:
    calls = levels x sum(niter), with a cell dia (rho) on the diffusion
    solves only."""
    _, tcfg = _configs(5)
    st = state_from_numpy(_state(5, seed=1), device="cpu")
    calls = []
    real = rbgs.rbgs_relax_alpha

    def spy(*args, **kw):
        calls.append(kw["dia_cell"])
        return real(*args, **kw)

    monkeypatch.setattr(rbgs, "rbgs_relax_alpha", spy)
    rec = _record(monkeypatch, tpoisson)
    tns.ns_step(st, 0.2 * tcfg.grid.h, 0.0, tcfg, first_step=True)
    levels = tcfg.grid.level - tcfg.projection.minlevel + 1
    assert len(rec) == 4
    assert len(calls) == levels * sum(rec)
    # call order: MAC projection, U and V diffusion, approximate projection
    assert calls == [False] * levels * rec[0] + [True] * levels * \
        (rec[1] + rec[2]) + [False] * levels * rec[3]


class _Dts:
    """Records each step's dt."""

    def __init__(self):
        self.dts = []

    def __call__(self, sim):
        self.dts.append(sim.dt)


def _jax_twophase_run():
    """The JAX side of test_twophase_simulation_run_matches_jax: the JAX
    Simulation at 64^2, init + 3 eager steps, and its dt sequence."""
    from gerris_tpu.events.events import Event as JEvent
    jcfg, _ = _configs(6)
    T0 = np.asarray(jvof.fraction_from_levelset(jcfg.grid, _level_set_j))
    jrec = _Dts()
    with jax.disable_jit():
        jsim = JSimulation(jcfg, time=JTime(end=10.0),
                           events=[JEvent(action=jrec, istep=1)])
        jsim.init(T=T0)
        jsim.run(max_steps=3)
    return {**{n: jsim.state[n] for n in ("U", "V", "T", "P")},
            "T0": T0, "dts": np.asarray(jrec.dts), "i": jsim.time.i}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"twophase_simulation": _jax_twophase_run,
            "twophase_steps": _jax_twophase_steps}


def test_twophase_simulation_run_matches_jax():
    """Simulation.init(T=...) + run for 3 steps against the JAX
    Simulation at 64^2 (pinned by tools/jax_pins.py,
    twophase_simulation): the initial projection with alpha, the VOF CFL
    and the capillary dt bound, the rotated sweep direction; the same dt
    sequence."""
    ref = jax_pins.load("twophase_simulation")
    _, tcfg = _configs(6)
    trec = _Dts()
    tsim = Simulation(tcfg, time=Time(end=10.0), device="cpu",
                      dtype=torch.float64,
                      events=[Event(action=trec, istep=1)])
    tsim.init(T=ref["T0"]).run(max_steps=3)
    assert tsim.time.i == int(ref["i"]) == 3
    assert len(trec.dts) == len(ref["dts"]) == 4
    assert np.allclose(trec.dts, ref["dts"], rtol=1e-12, atol=0.0)
    for n in ("U", "V", "T"):
        assert _rel(ref[n], tsim.state[n]) <= RTOL, n
    assert _rel(ref["P"], tsim.state["P"], mean_free=True) <= RTOL


# --- the reference's test/oscillation on the port (tests/test_oscillation.py) --

D = 0.2
EPS = 0.05
SIGMA = 1.0
RHO_L, RHO_G = 1.0, 1e-3
OMEGA0 = math.sqrt((8 - 2) * SIGMA / ((RHO_L + RHO_G) * (D / 2) ** 3))
REF_C = {5: 152.80, 6: 153.984, 7: 154.591, 8: 154.785}


def oscillation_phi(x, y):
    """The quarter droplet at the corner, its radius perturbed by the n=2
    mode; fluid (T = 1) inside."""
    xx, yy = x + 0.5, y + 0.5
    r = D / 2.0 * (1.0 + EPS * torch.cos(2.0 * torch.atan2(yy, xx)))
    return r * r - (xx * xx + yy * yy)


def oscillation_cfg(level):
    """test/oscillation: symmetry walls (normal velocity Dirichlet 0,
    tangential Neumann), nu 0, sigma 1, rho 1 / 1e-3 through the filtered
    fraction, projections adaptive to 1e-4."""
    grid = TGrid(level=level)
    u_bc = tbc.FieldBC((((tbc.Dirichlet(0.0),) * 2), ((tbc.Neumann(),) * 2)))
    v_bc = tbc.FieldBC((((tbc.Neumann(),) * 2), ((tbc.Dirichlet(0.0),) * 2)))
    proj = tpoisson.MultilevelParams(tolerance=1e-4, nitermax=100)
    return tns.NSConfig(
        grid=grid, u_bcs=(u_bc, v_bc), nu=0.0,
        vof_tracers=(("T", tbc.default_scalar_bc(2)),),
        tension=(("T", SIGMA),), density=("T", RHO_L, RHO_G, 1),
        projection=proj, approx_projection=proj)


def oscillation_run(level, t_end=1.0, device="cpu", dtype=torch.float64):
    """[(t, kinetic energy)] of the oscillating droplet to t_end."""
    cfg = oscillation_cfg(level)
    h2 = cfg.grid.h ** 2
    ke = []

    def record(sim):
        s = sim.state
        rho = RHO_G + torch.clamp(s["T"], 0, 1) * (RHO_L - RHO_G)
        ke.append((sim.time.t, float(torch.sum(
            rho * (s["U"] ** 2 + s["V"] ** 2)) * h2)))

    sim = Simulation(cfg, time=Time(end=t_end), device=device, dtype=dtype,
                     events=[Event(action=record, istep=1)])
    sim.init(T=tvof.fraction_from_levelset(cfg.grid, oscillation_phi,
                                           device=device, dtype=dtype))
    sim.run()
    return np.array(ke)


def fit_ke(ke):
    """Fit k(t) = a exp(-b t) (1 - cos(c t)) (oscillation.sh's gnuplot
    fit)."""
    from scipy.optimize import curve_fit

    def model(t, a, b, c):
        return a * np.exp(-b * t) * (1.0 - np.cos(c * t))

    popt, _ = curve_fit(model, ke[:, 0], ke[:, 1],
                        p0=(3e-4, 1.5, 2 * OMEGA0), maxfev=20000)
    return popt


@pytest.mark.slow
def test_oscillation_frequency():
    level = 6
    a, b, c = fit_ke(oscillation_run(level))
    # the frequency within 0.5% of the reference's fit, decaying
    assert abs(c - REF_C[level]) / REF_C[level] < 0.005
    assert b > 0
