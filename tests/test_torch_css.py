"""The CSS surface tension (``NSConfig.tension_css``,
``physics/tension.css_tension_sources``) and the static droplet of the
reference's test/spurious on the port, against ``gerris_tpu`` on the CPU
in float64.

The static droplet (Popinet, J. Comput. Phys. 228 (2009) 5838-5866;
tests/test_spurious.py): the droplet of radius 0.4 at (-0.5, 0.5) in the
unit box, velocity_bc walls, sigma 1, rho 1, nu = sqrt(0.8 / 12000),
``scheme="none"``, projections to 1e-6 in at most 100 cycles, diffusion
to 1e-6 in at most 20; with the well-balanced tension and with the CSS
one; and the sessile drop of tests/test_torch_contact.py with its
contact angles, a tension-driven drop on a wall.  The JAX steps run
eagerly (``jax.disable_jit``) so that each solve's niter can be read.  Bound: U, V, T and mean-free P within 1e-9
of max, equal niter per solve."""
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
from gerris_tpu.physics import tension as jtens  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.solvers import advection as jadv  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.physics import tension as ttens  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            grid_from_jax, state_from_numpy)

from test_torch_contact import sessile_T, sessile_jcfg  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-9
LA = 12000.0
R = 0.4


def _rel(a, b, mean_free=False):
    a = np.asarray(a, dtype=np.float64)
    b = b.double().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _record(monkeypatch, module):
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
    yield
    jns.ns_step.clear_cache()


def spurious_jcfg(level, kind="tension", dense=1024):
    """test/spurious's NSConfig at ``level`` with ``kind`` ("tension" or
    "tension_css"); the dense coarsest solve capped at ``dense`` unknowns
    on both sides (the JAX CPU cap)."""
    mp = dict(dense_coarse_max=dense)
    return jns.NSConfig(
        grid=JGrid(level=level, dim=2),
        u_bcs=(jbc.velocity_bc(0, 2), jbc.velocity_bc(1, 2)),
        nu=math.sqrt(0.8 / LA), beta=1.0,
        advection=jadv.AdvectionParams(scheme="none"),
        vof_tracers=(("T", jbc.default_scalar_bc(2)),),
        projection=jpoisson.MultilevelParams(tolerance=1e-6, nitermax=100,
                                             **mp),
        approx_projection=jpoisson.MultilevelParams(tolerance=1e-6,
                                                    nitermax=100, **mp),
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-6,
                                                   nitermax=20, **mp),
        **{kind: (("T", 1.0),)})


def _port_cfg(jcfg):
    """config_from_jax, on the JAX params as they are (no TPU floors)."""
    tcfg = config_from_jax(jcfg)

    def p(jp):
        return tpoisson.MultilevelParams(
            tolerance=jp.tolerance, nitermax=jp.nitermax,
            dense_coarse_max=jp.dense_coarse_max)

    return dataclasses.replace(
        tcfg, projection=p(jcfg.projection),
        approx_projection=p(jcfg.approx_projection),
        diffusion_params=p(jcfg.diffusion_params))


def _droplet(grid):
    return np.array(jvof.fraction_from_levelset(
        grid, lambda x, y: R * R - ((x + 0.5) ** 2 + (y - 0.5) ** 2)))


def test_youngs_gradient_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((18, 22))
    for r, g in zip(jtens._youngs_gradient(jnp.asarray(a)),
                    ttens._youngs_gradient(torch.from_numpy(a))):
        assert np.array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("field", ["droplet", "random"])
def test_css_sources_match_jax(field, alpha):
    """css_tension_sources of the droplet's fraction and of a random field
    at 32^2 (with Dirichlet sides: every ghost formula), with and without
    a cell alpha = 1/rho."""
    jg = JGrid(level=5)
    rng = np.random.default_rng(1)
    T = _droplet(jg) if field == "droplet" else rng.random(jg.shape)
    fbc = jbc.FieldBC.make(2, left=jbc.Dirichlet(0.2), top=jbc.Neumann(0.5))
    a = 1.0 / (1.0 + rng.random(jg.shape)) if alpha else None
    ref = jtens.css_tension_sources(jnp.asarray(T), 0.7, jg, fbc,
                                    alpha_cell=None if a is None
                                    else jnp.asarray(a))
    got = ttens.css_tension_sources(
        torch.from_numpy(T), 0.7, grid_from_jax(jg),
        tbc.FieldBC.make(2, left=tbc.Dirichlet(0.2), top=tbc.Neumann(0.5)),
        alpha_cell=None if a is None else torch.from_numpy(a))
    for r, g in zip(ref, got):
        assert _rel(r, g) <= 1e-13


def test_css_sources_float32_have_no_nan():
    """In float32 the reference's guard sqrt(|n|^2 + 1e-50) is sqrt(0)
    where T has no gradient, and its g = nx^2 / |n| are 0/0: NaN in
    every cell near a full or empty region (a fault of gerris_tpu/
    physics/tension.py:115, ROADMAP Queue 3).  The port's g are 0 there,
    and elsewhere its float32 sources agree with its float64 ones."""
    jg = JGrid(level=5)
    T = _droplet(jg)
    ref32 = jtens.css_tension_sources(jnp.asarray(T, jnp.float32), 1.0, jg,
                                      jbc.default_scalar_bc(2))
    assert not bool(jnp.isfinite(ref32[0]).all())
    tg = grid_from_jax(jg)
    got32 = ttens.css_tension_sources(torch.from_numpy(T).float(), 1.0, tg,
                                      tbc.default_scalar_bc(2))
    got64 = ttens.css_tension_sources(torch.from_numpy(T), 1.0, tg,
                                      tbc.default_scalar_bc(2))
    for g32, g64 in zip(got32, got64):
        assert bool(torch.isfinite(g32).all())
        assert _rel(g64, g32) <= 1e-5


def _static_state(grid):
    st = {n: np.zeros(grid.shape) for n in
          ("U", "V", "P", "Pmac", "Gx", "Gy")}
    st["T"] = _droplet(grid)
    return st


def _jax_static(kind):
    """The JAX side of test_static_droplet_steps_match_jax: the initial
    projection and 3 eager steps, and every solve's niter."""
    jcfg = spurious_jcfg(5, kind)
    js = {k: jnp.asarray(v) for k, v in _static_state(jcfg.grid).items()}
    dt = jtens.stability_dt(jcfg.grid, 1.0)
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        js = jns.initial_projection(js, dt, 0.0, jcfg)
        for i in range(3):
            js = jns.ns_step(js, dt, i * dt, jcfg, cstart=i % 2,
                             first_step=i == 0)
    return {**{n: js[n] for n in ("U", "V", "T", "P")},
            "niter": np.asarray(rec)}


@pytest.mark.parametrize("kind", ["tension", "tension_css"])
def test_static_droplet_steps_match_jax(monkeypatch, kind):
    """3 steps of the static droplet at level 5 from rest after the
    initial projection, dt the capillary bound: U, V, T and mean-free P
    within 1e-9 of max, and the niter of every solve (4 a step), against
    the JAX package's run pinned by tools/jax_pins.py (css_static_KIND)."""
    ref = jax_pins.load(f"css_static_{kind}")
    jcfg = spurious_jcfg(5, kind)
    tcfg = _port_cfg(jcfg)
    assert getattr(tcfg, kind) == (("T", 1.0),)
    ts = state_from_numpy(_static_state(jcfg.grid), device="cpu")
    dt = jtens.stability_dt(jcfg.grid, 1.0)
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    ts = tns.initial_projection(ts, dt, 0.0, tcfg)
    for i in range(3):
        ts = tns.ns_step(ts, dt, i * dt, tcfg, first_step=i == 0,
                         cstart=i % 2)
    assert trec == list(ref["niter"]) and len(trec) == 13, (trec, ref)
    for n in ("U", "V", "T"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def test_css_takes_the_capillary_timestep():
    """The port's Simulation bounds dt by the capillary stability
    sqrt(h^3 / (pi sigma)) for the CSS tension as for the other: both
    are GfsSourceTensionGeneric in the reference C, whose stability
    method gives it (src/tension.c:106-137).  gerris_tpu's Simulation
    applies it to ``tension`` only (gerris_tpu/models/simulation.py:
    97-102; ROADMAP Queue 3), so from rest its first CSS dt is the whole
    CFL-free step, here the end time."""
    jcfg = spurious_jcfg(4, "tension_css")
    tcfg = _port_cfg(jcfg)
    cap = jtens.stability_dt(jcfg.grid, 1.0)
    s = Simulation(tcfg, time=Time(end=1.0), device="cpu")
    s.init(T=_droplet(jcfg.grid))
    s.set_timestep()
    assert s.dt == pytest.approx(1.0 / math.ceil(1.0 / cap), rel=1e-12)
    js = JSimulation(jcfg, time=JTime(end=1.0))
    js.init(T=jnp.asarray(_droplet(jcfg.grid)))
    js.set_timestep()
    assert js.dt == 1.0
    # with the bound as dtmax the two take the same steps
    js = JSimulation(jcfg, time=JTime(end=1.0, dtmax=cap))
    js.init(T=jnp.asarray(_droplet(jcfg.grid)))
    js.set_timestep()
    assert js.dt == s.dt


def _sessile_state(grid):
    st = {n: np.zeros(grid.shape) for n in
          ("U", "V", "P", "Pmac", "Gx", "Gy")}
    st["T"] = sessile_T(grid)
    return st


def _jax_sessile(angle):
    """The JAX side of test_sessile_steps_match_jax: the initial
    projection and 3 eager steps, and every solve's niter."""
    jcfg = sessile_jcfg(5, angle)
    js = {k: jnp.asarray(v) for k, v in _sessile_state(jcfg.grid).items()}
    dt = math.sqrt(jcfg.grid.h ** 3 / math.pi)
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        js = jns.initial_projection(js, dt, 0.0, jcfg)
        for i in range(3):
            js = jns.ns_step(js, dt, i * dt, jcfg, cstart=i % 2,
                             first_step=i == 0)
    return {**{n: js[n] for n in ("U", "V", "T", "P")},
            "niter": np.asarray(rec)}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {**{f"css_static_{k}": functools.partial(_jax_static, k)
               for k in ("tension", "tension_css")},
            **{f"css_sessile_{a:g}": functools.partial(_jax_sessile, a)
               for a in (60.0, 120.0)}}


@pytest.mark.parametrize("angle", (60.0, 120.0))
def test_sessile_steps_match_jax(monkeypatch, angle):
    """3 steps of the sessile drop (tests/test_torch_contact.py: the
    contact angle on the bottom wall, tension 1, nu 0.1) at level 5 from
    rest, dt the capillary bound: U, V, T and mean-free P within 1e-9 of
    max, and the niter of every solve (4 a step and the initial
    projection's), against the JAX package's run pinned by
    tools/jax_pins.py (css_sessile_60, css_sessile_120)."""
    ref = jax_pins.load(f"css_sessile_{angle:g}")
    jcfg = sessile_jcfg(5, angle)
    tcfg = config_from_jax(jcfg)
    p = tpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                  dense_coarse_max=1024)
    tcfg = dataclasses.replace(tcfg, projection=p, approx_projection=p,
                               diffusion_params=dataclasses.replace(
                                   p, nitermax=10))
    assert tcfg.vof_tracers[0][1].sides[1][0] == tbc.Contact(angle)
    ts = state_from_numpy(_sessile_state(jcfg.grid), device="cpu")
    dt = math.sqrt(jcfg.grid.h ** 3 / math.pi)
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    ts = tns.initial_projection(ts, dt, 0.0, tcfg)
    for i in range(3):
        ts = tns.ns_step(ts, dt, i * dt, tcfg, first_step=i == 0,
                         cstart=i % 2)
    assert trec == list(ref["niter"]) and len(trec) == 13, (trec, ref)
    for n in ("U", "V", "T"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
    assert all(v == 0 for v in rbgs.LAUNCHES.values())
