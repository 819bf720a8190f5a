"""The port's 2D step on periodic BCs against gerris_tpu on the CPU, and
the Taylor-Green gates of tests/test_ns.py on the port.

On BCs that no kernel takes (periodic rows, periodic y in the corrector
advection, inhomogeneous Neumann) the reference runs its generic route,
which pads the BCG ghosts with corners=False
(gerris_tpu/solvers/advection.py:101).  The port pads them so on those
BCs, and in the kernels' order only where a kernel takes the BCs
(solvers/advection.advected_face_values, kernel_corners).  Every solve
runs adaptively to 1e-10 with the dense coarsest solve at the 32^2 level,
so the TPU floors that params_from_jax applies change no result.
Tolerances, float64: 1e-9 of max|ref| on U and V and on P with its mean
taken out (a pure-Neumann or periodic pressure is defined up to a
constant); 1e-12 for the advection alone, which involves no solve.
"""
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
from gerris_tpu.ops.pallas import bcg as jbcg  # noqa: E402
from gerris_tpu.ops.pallas import predict as jpredict  # noqa: E402
from gerris_tpu.ops.stencils import face_average as jface_average  # noqa: E402
from gerris_tpu.solvers import advection as jadv  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg as tbcg  # noqa: E402
from gerris_tpu_torch.ops.stencils import divergence  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.solvers import projection as tproj  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            state_from_numpy)

LEVEL = 5
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

STEPS = 5
RTOL = 1e-9
ADVECT_RTOL = 1e-12
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
PER = (jbc.Periodic(), jbc.Periodic())


def _params():
    return jpoisson.MultilevelParams(tolerance=1e-10, nitermax=100,
                                     dense_coarse_max=1024)


def _cfg(u_bcs, level=LEVEL):
    p = _params()
    return jns.NSConfig(grid=JGrid(level=level), u_bcs=u_bcs, nu=0.01,
                        beta=1.0, projection=p, approx_projection=p,
                        diffusion_params=p)


def doubly_periodic_cfg():
    per = jbc.FieldBC((PER, PER))
    return _cfg((per, per))


def channel_cfg():
    """Dirichlet-0 x walls, periodic y."""
    wall = jbc.FieldBC(((jbc.Dirichlet(0.0), jbc.Dirichlet(0.0)), PER))
    return _cfg((wall, wall))


def _state(seed, shape, u_mean=0.0):
    rng = np.random.default_rng(seed)
    st = {n: 0.1 * rng.standard_normal(shape) for n in NAMES}
    st["U"] = st["U"] + u_mean
    return st


def _rel(ref, got, mean_free=False):
    ref = np.asarray(ref)
    got = got.cpu().numpy()
    if mean_free:
        ref, got = ref - ref.mean(), got - got.mean()
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _steps(jcfg, st, steps, jax_=True, port=True):
    """``steps`` steps of the JAX step (jitted, one program) and of the
    port's on the carried-over config, at dt = 0.4 h (either side left
    out: None)."""
    dt = 0.4 * jcfg.grid.h
    js = ts = None
    if jax_:
        js = {k: jnp.asarray(v) for k, v in st.items()}
        first = jax.jit(lambda s: jns.ns_step(s, dt, 0.0, jcfg,
                                              first_step=True))
        step = jax.jit(lambda s: jns.ns_step(s, dt, 0.0, jcfg))
        for i in range(steps):
            js = (first if i == 0 else step)(js)
    if port:
        tcfg = config_from_jax(jcfg)
        ts = state_from_numpy(st, device="cpu")
        for i in range(steps):
            ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=i == 0)
    return js, ts


def _hold(js, ts, bound):
    errs = {n: _rel(js[n], ts[n], mean_free=n == "P") for n in ("U", "V", "P")}
    print("rel errors (P mean-free):", errs)
    assert all(e <= bound for e in errs.values()), errs


def _jax_doubly_periodic():
    """The JAX side of test_doubly_periodic_step_matches_jax: STEPS
    jitted steps."""
    jcfg = doubly_periodic_cfg()
    return _steps(jcfg, _state(0, jcfg.grid.shape), STEPS, port=False)[0]


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"periodic_doubly": _jax_doubly_periodic}


def test_doubly_periodic_step_matches_jax():
    """5 steps at 32^2 from a seeded random state, against the JAX
    package's jitted steps pinned by tools/jax_pins.py (periodic_doubly).
    No kernel takes periodic rows, so every BCG advection pads
    corners=False, as the reference does: with the kernels' corner order
    P differed by 1e-4."""
    ref = jax_pins.load("periodic_doubly")
    jcfg = doubly_periodic_cfg()
    tcfg = config_from_jax(jcfg)
    assert tbcg.face_specs(tcfg.u_bcs) is None
    assert tbcg.advect_spec(tcfg.u_bcs[0]) is None
    _, ts = _steps(jcfg, _state(0, jcfg.grid.shape), STEPS, jax_=False)
    _hold(ref, ts, RTOL)


def test_channel_corrector_advection_matches_generic_route():
    """The periodic-y channel's corrector advection (the port's advect2d
    plain version, which its route takes for periodic y) against the
    reference's generic route (gerris_tpu/models/ns.py:375-410) on the
    same MAC faces, gmac and g_prev."""
    jcfg = channel_cfg()
    tcfg = config_from_jax(jcfg)
    grid, tgrid = jcfg.grid, tcfg.grid
    rng = np.random.default_rng(3)
    n = grid.shape[0]
    v, g, gp = 0.1 * rng.standard_normal((3, n, n))
    v = v + 1.0
    ufx = 1.0 + 0.1 * rng.standard_normal((n + 1, n))
    ufy = 0.1 * rng.standard_normal((n, n + 1))
    dt = 0.4 * grid.h
    gbc = jns.grad_bc(jcfg.u_bcs[0])
    uf = [jnp.asarray(ufx), jnp.asarray(ufy)]
    uc_pad = jadv.mac_cell_mean(uf, grid)
    for c in range(2):
        fbc = jcfg.u_bcs[c]
        assert jbcg.kernel_spec(fbc, with_face_bc=True)["per_y"]
        assert tbcg.advect_spec(tcfg.u_bcs[c]) is None
        fvals = jadv.advected_face_values(jnp.asarray(v), grid, fbc, dt,
                                          jcfg.advection, uc_pad)
        g_pad = jbc.apply_bc(jnp.asarray(g), grid, gbc, 1, corners=False)
        faces = []
        for a in range(2):
            f = jadv.upwind_face_value(fvals[a][0], fvals[a][1], uf[a], a)
            f = f - jface_average(g_pad, grid, a) * dt / 2.0
            if a == c:
                f = jbc.apply_face_bc(f, grid, fbc, a)
            faces.append(f)
        ref = jadv.flux_divergence(faces, uf, grid, dt) - dt * gp
        t = [torch.from_numpy(x) for x in (v, ufx, ufy, g, gp)]
        got = tbcg.advect2d_plain(t[0], c, t[1], t[2], dt, tgrid,
                                  tcfg.u_bcs[c], g=t[3], gp=t[4])
        err = _rel(ref, got)
        print(f"component {c}: rel {err:.3e}")
        assert err <= ADVECT_RTOL


def _k6_predictor(U, grid, cfg, dt, t, packed=False, div_scale=None):
    """The reference's predictor as the TPU runs it on these BCs: K6
    predict_xy, here in interpret mode (gerris_tpu/models/ns.py:190-206)."""
    su = jbcg.kernel_spec(cfg.u_bcs[0], with_face_bc=True)
    sv = jbcg.kernel_spec(cfg.u_bcs[1], with_face_bc=True)
    out = jpredict.predict_xy(
        U[0], U[1], dt, grid.h, sgn_u=su["sgn"], off_u=su["off"],
        sgn_v=sv["sgn"], off_v=sv["off"], per_y=su["per_y"],
        fb_x=su["fb_x"], fb_y=sv["fb_y"] or (0.0, 0.0), interpret=True)
    uf = [out[0], out[1]]
    return (uf, None) if div_scale is not None else uf


def _channel_case():
    # a config no other test compiles, so the swapped predictor is traced
    jcfg = dataclasses.replace(channel_cfg(), nu=0.0125)
    return jcfg, _state(1, jcfg.grid.shape, u_mean=1.0)


def _jax_channel():
    """The JAX side of test_channel_step_matches_jax_with_k6_predictor:
    STEPS jitted steps with K6 (interpret mode) as the predictor."""
    real = jns.predicted_face_velocities
    jns.predicted_face_velocities = _k6_predictor
    try:
        jcfg, st = _channel_case()
        return _steps(jcfg, st, STEPS, port=False)[0]
    finally:
        jns.predicted_face_velocities = real


def test_channel_step_matches_jax_with_k6_predictor():
    """5 steps of the periodic-y channel (U = 1 + noise).  K6 takes these
    BCs, so the port's predictor runs K6's function on every device; the
    reference runs K6 on the TPU only, so its step here gets K6 in
    interpret mode in place of its CPU predictor (pinned by
    tools/jax_pins.py, periodic_channel).  Every other phase takes the
    generic route on both sides (periodic y: no K14)."""
    ref = jax_pins.load("periodic_channel")
    jcfg, st = _channel_case()
    _, ts = _steps(jcfg, st, STEPS, jax_=False)
    errs = {n: _rel(ref[n], ts[n], mean_free=n == "P")
            for n in ("U", "V", "P")}
    print("rel errors (P mean-free):", errs)
    assert errs["U"] <= RTOL and errs["V"] <= RTOL, errs
    assert errs["P"] <= 1e-8, errs


# -----------------------------------------------------------------------------
# tests/test_ns.py's gates on the port: the doubly periodic Taylor-Green
# vortex with beta = 0.5 (u = -cos(2 pi x) sin(2 pi y) exp(-8 pi^2 nu t))
# -----------------------------------------------------------------------------

NU = 0.01


def tg_u(x, y, t, nu=NU):
    return -np.cos(2 * math.pi * x) * np.sin(2 * math.pi * y) * \
        math.exp(-8 * math.pi ** 2 * nu * t)


def tg_v(x, y, t, nu=NU):
    return np.sin(2 * math.pi * x) * np.cos(2 * math.pi * y) * \
        math.exp(-8 * math.pi ** 2 * nu * t)


def tg_cfg(level):
    per = tbc.FieldBC.uniform(tbc.Periodic(), 2)
    p = tpoisson.MultilevelParams(tolerance=1e-9, nitermax=50,
                                  dense_coarse_max=1024)
    return tns.NSConfig(grid=TGrid(level=level), u_bcs=(per, per), nu=NU,
                        beta=0.5, projection=p, approx_projection=p)


def run_tg(level, t_end=0.25):
    cfg = tg_cfg(level)
    x, y = cfg.grid.centers
    sim = Simulation(cfg, time=Time(end=t_end, dtmax=0.5 * cfg.grid.h),
                     device="cpu", dtype=torch.float64)
    sim.init(U=tg_u(x, y, 0.0), V=tg_v(x, y, 0.0))
    sim.run()
    err = float(np.max(np.abs(sim.state["U"].numpy()
                              - tg_u(x, y, sim.time.t)))
                + np.max(np.abs(sim.state["V"].numpy()
                                - tg_v(x, y, sim.time.t))))
    return sim, err


def test_taylor_green_accuracy_and_order():
    _, e4 = run_tg(4)
    _, e5 = run_tg(5)
    order = math.log2(e4 / e5)
    print(f"TG errors: L4={e4:.3e} L5={e5:.3e} order={order:.2f}")
    assert e5 < 2e-2
    assert order > 1.5


def test_divergence_free():
    """The MAC projection's faces are divergence-free to its tolerance
    (the centred field only approximately, by design: src/timestep.c:
    541-556)."""
    sim, _ = run_tg(4, t_end=0.1)
    cfg = sim.cfg
    U = [sim.state["U"], sim.state["V"]]
    uf, _, _ = tproj.face_interpolated_velocity(U, cfg.grid, list(cfg.u_bcs))
    div0 = float(divergence(uf, cfg.grid).abs().max())
    uf2, _, _, _, _ = tproj.mac_projection(uf, sim.state["P"], cfg.grid,
                                           cfg.p_bc, sim.dt,
                                           cfg.approx_projection)
    div1 = float(divergence(uf2, cfg.grid).abs().max())
    print(f"div before {div0:.2e} after {div1:.2e}")
    assert div1 < 1e-7 * div0


def test_energy_decay_rate():
    """Kinetic energy decays as exp(-16 pi^2 nu t)."""
    sim, _ = run_tg(5, t_end=0.2)
    x, y = sim.cfg.grid.centers
    ke = float((sim.state["U"] ** 2 + sim.state["V"] ** 2).mean())
    ke0 = float(np.mean(tg_u(x, y, 0.0) ** 2 + tg_v(x, y, 0.0) ** 2))
    rate = -math.log(ke / ke0) / sim.time.t
    expect = 16 * math.pi ** 2 * NU
    print(f"decay rate {rate:.3f} vs analytic {expect:.3f}")
    assert abs(rate - expect) / expect < 0.05



JAX_PINS["periodic_channel"] = _jax_channel
