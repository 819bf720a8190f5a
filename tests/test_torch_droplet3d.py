"""The 3D static droplet (tests/test_vof3d.py::test_static_droplet_3d, the
3D counterpart of Gerris test/spurious) on the port against
``gerris_tpu`` on the CPU in float64.

The configuration: a sphere of radius 0.3 at the centre of the unit box,
velocity_bc walls, sigma 1, rho 1, nu 0.1, beta 1, ``scheme="none"``,
both projections to 1e-6 in at most 50 cycles, the default diffusion.
Both sides take the dense coarsest solve at 8^3 (``dense_coarse_max``
1024, the JAX package's cap on the CPU).  The JAX step runs eagerly
(``jax.disable_jit``) so that each solve's niter can be read; one step
costs ~25 s, so one is compared, and longer runs are the port's alone.
Every solve of this configuration runs K13's plain version on the CPU
(a scalar dia, Dirichlet/Neumann sides)."""
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
from gerris_tpu.physics import tension as jtens  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.solvers import advection as jadv  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs, rbgs3d  # noqa: E402
from gerris_tpu_torch.physics import tension as ttens  # noqa: E402
from gerris_tpu_torch.physics import vof as tvof  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            fieldbc_from_jax, state_from_numpy)
from gerris_tpu_torch.utils.convert import \
    grid_from_jax as convert_grid  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-9
R = 0.3


def _rel(a, b, mean_free=False):
    a = np.asarray(a, dtype=np.float64)
    b = b.double().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
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


def droplet_jcfg(level):
    """test_static_droplet_3d's configuration at ``level``, dense at 8^3."""
    proj = jpoisson.MultilevelParams(tolerance=1e-6, nitermax=50,
                                     dense_coarse_max=1024)
    return jns.NSConfig(
        grid=JGrid(level=level, dim=3, origin=(-0.5, -0.5, -0.5)),
        u_bcs=tuple(jbc.velocity_bc(c, 3) for c in range(3)),
        nu=0.1, beta=1.0, advection=jadv.AdvectionParams(scheme="none"),
        vof_tracers=(("T", jbc.default_scalar_bc(3)),), tension=(("T", 1.0),),
        projection=proj, approx_projection=proj,
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-3,
                                                   nitermax=10,
                                                   dense_coarse_max=1024))


def _sphere(x, y, z):
    return R * R - (x * x + y * y + z * z)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_step_cache():
    """Drop this module's compiled JAX steps when it ends: other files on
    the same test worker count ns_step's jit cache entries
    (tests/test_rigid.py)."""
    yield
    jns.ns_step.clear_cache()
    jns.initial_projection.clear_cache()


def test_config_carries_the_3d_droplet():
    tcfg = config_from_jax(droplet_jcfg(4))
    assert tcfg.grid.shape == (16, 16, 16) and tcfg.dim == 3
    assert tcfg.tension == (("T", 1.0),) and tcfg.advection.scheme == "none"
    assert (tcfg.projection.tolerance, tcfg.projection.nitermax) == (1e-6, 50)


def _droplet3d_state(T0):
    st = {n: np.zeros(T0.shape) for n in
          ("U", "V", "W", "P", "Pmac", "Gx", "Gy", "Gz")}
    st["T"] = T0
    return st


def _jax_droplet3d():
    """The JAX side of test_droplet3d_step_matches_jax: the sphere's
    fraction, the initial projection and one eager step, and every
    solve's niter."""
    jcfg = droplet_jcfg(4)
    T0 = np.asarray(jvof.fraction_from_levelset(jcfg.grid, _sphere))
    js = {k: jnp.asarray(v) for k, v in _droplet3d_state(T0).items()}
    dt = jtens.stability_dt(jcfg.grid, 1.0)
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        js = jns.initial_projection(js, dt, 0.0, jcfg)
        js = jns.ns_step(js, dt, 0.0, jcfg, cstart=0, first_step=True)
    return {**dict(js), "T0": T0, "dt": dt, "niter": np.asarray(rec)}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"droplet3d_step": _jax_droplet3d}


def test_droplet3d_step_matches_jax(monkeypatch):
    """init (the initial projection) and one step at 16^3, dt the
    capillary bound: U, V, W, T and mean-free P within 1e-9 of max, the
    same niter for every solve (2 projections and 3 diffusions), and the
    velocity non-zero after the step (the tension drives it), against
    the JAX package's eager run pinned by tools/jax_pins.py
    (droplet3d_step; the sphere's fraction from it too)."""
    ref = jax_pins.load("droplet3d_step")
    jcfg = droplet_jcfg(4)
    tcfg = config_from_jax(jcfg)
    ts = state_from_numpy(_droplet3d_state(ref["T0"]), device="cpu")
    dt = float(ref["dt"])
    assert dt == ttens.stability_dt(tcfg.grid, 1.0)
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    rbgs3d.reset_launch_counts()
    ts = tns.initial_projection(ts, dt, 0.0, tcfg)
    ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=True, cstart=0)
    assert len(trec) == 6 and trec == list(ref["niter"]), (trec, ref)
    for n in ("U", "V", "W", "T", "Gx", "Gy", "Gz", "Pmac"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
    umax = float(torch.sqrt(ts["U"] ** 2 + ts["V"] ** 2 + ts["W"] ** 2).max())
    assert umax > 1e-4, umax
    # no kernel launches on the CPU: the plain versions ran
    assert all(v == 0 for v in rbgs.LAUNCHES.values())
    assert all(v == 0 for v in rbgs3d.LAUNCHES.values())


def test_droplet3d_simulation(monkeypatch):
    """The port alone for 5 Simulation steps at 16^3 to end time 1: the
    capillary dt bound (below the CFL's at these velocities), the VOF
    sweeps' first direction rotating over the three axes, T's volume
    conserved and the droplet at rest to the tension's parasitic
    currents (test_static_droplet_3d's bounds)."""
    tcfg = config_from_jax(droplet_jcfg(4))
    T0 = tvof.fraction_from_levelset(tcfg.grid, _sphere, device="cpu")
    cstarts, dts = [], []
    real = tvof.advect

    def spy(*args, **kw):
        cstarts.append(kw["cstart"])
        return real(*args, **kw)

    monkeypatch.setattr(tvof, "advect", spy)
    sim = Simulation(tcfg, time=Time(end=1.0), device="cpu").init(T=T0)
    for _ in range(5):
        sim.run(max_steps=1)
        dts.append(sim.dt)
    # the capillary bound, snapped to divide the time to the end
    cap = ttens.stability_dt(tcfg.grid, 1.0)
    dt = 1.0 / math.ceil(1.0 / cap)
    assert dts == [dt] * 5 and dt <= cap
    assert sim.time.i == 5 and sim.time.t == pytest.approx(5 * dt, rel=1e-12)
    assert cstarts == [0, 1, 2, 0, 1]
    # the sweeps conserve T's volume to the faces' divergence, which the
    # projections leave at their 1e-6 tolerance: ~1e-8 of it a step at
    # 16^3, in the reference as here (to 1e-11 it is ~1e-13 a step)
    T = sim.state["T"]
    assert abs(float(T.sum() - T0.sum())) / float(T0.sum()) < 1e-7
    u = torch.sqrt(sim.state["U"] ** 2 + sim.state["V"] ** 2
                   + sim.state["W"] ** 2)
    assert 0.0 < float(u.max()) < 5e-2
    assert float((T - T0).abs().max()) < 2.5e-2
    assert math.isfinite(float(sim.state["P"].abs().max()))


def test_box_routes_3d_match_jax():
    """The 3D box of (1, 2, 1) unit boxes (the 3D bubble's, 16 x 32 x 16)
    on the multigrid's routes, against gerris_tpu: the 2x2x2
    restriction, the trilinear prolongation from 8 x 16 x 8, the face
    coefficients' coarsening, one correction with face coefficients and
    a cell dia (the torch correction and smoother, down to 1 x 2 x 1),
    and one with a scalar dia (K13's plain version above the dense 4 x 8
    x 4 level, + u); every value within 1e-9 of max."""
    jg = JGrid(level=4, dim=3, origin=(0.0, 0.0, 0.0), extents=(1, 2, 1))
    tg = convert_grid(jg)
    jfbc = jbc.FieldBC(((jbc.Dirichlet(0.0), jbc.Dirichlet(0.0)),
                        (jbc.Neumann(), jbc.Dirichlet(0.0)),
                        (jbc.Neumann(), jbc.Neumann())))
    tfbc = fieldbc_from_jax(jfbc)
    rng = np.random.default_rng(9)
    u, rhs = (rng.standard_normal(jg.shape) for _ in range(2))
    assert _rel(jpoisson.restrict(jnp.asarray(u), 3),
                tpoisson.restrict(torch.from_numpy(u))) <= RTOL
    c = rng.standard_normal((8, 16, 8))
    jgc = JGrid(level=3, dim=3, origin=(0.0, 0.0, 0.0), extents=(1, 2, 1))
    assert _rel(jpoisson.prolong(jnp.asarray(c), jgc, jfbc),
                tpoisson.prolong(torch.from_numpy(c), tfbc,
                                 convert_grid(jgc))) <= RTOL
    alpha = [0.5 + rng.random(jg.face_shape(a)) for a in range(3)]
    for a, b in zip(jpoisson.coarsen_face_coeff(
            [jnp.asarray(x) for x in alpha], 3),
            tpoisson.coarsen_face_coeff(
                [torch.from_numpy(x) for x in alpha], 3)):
        assert _rel(a, b) <= RTOL
    dia = 1.0 + rng.random(jg.shape)
    mp = dict(dense_coarse_max=128)
    jp, tp = jpoisson.MultilevelParams(**mp), tpoisson.MultilevelParams(**mp)
    ref = jpoisson.correction(jnp.asarray(rhs), jg, jfbc, jp,
                              dia=jnp.asarray(dia),
                              alpha=[jnp.asarray(x) for x in alpha])
    got = tpoisson.correction(torch.from_numpy(rhs), tg, tfbc, tp,
                              dia=torch.from_numpy(dia),
                              alpha=[torch.from_numpy(x) for x in alpha])
    assert _rel(ref, got) <= RTOL
    ref = jpoisson.correction(jnp.asarray(rhs), jg, jfbc, jp, dia=30.0,
                              u_fine=jnp.asarray(u))
    got = tpoisson.correction(torch.from_numpy(rhs), tg, tfbc, tp, dia=30.0,
                              u_fine=torch.from_numpy(u))
    assert _rel(ref, got) <= RTOL
