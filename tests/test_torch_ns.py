"""The port's lid-cavity step and Simulation against gerris_tpu on the CPU.

Both packages run the bench schedule (tests/test_bench_schedule.py:
projections 5 sweeps with omega 1.5, diffusion 1 sweep, one cycle per
solve) as the TPU's fused path runs it: nrelax sweeps at every level and
40 sweeps from zero at 16^2.  The port takes that schedule from
config_from_jax; the JAX CPU path runs the same sweeps only with
MultilevelParams(ncycles=1, nrelax=N, omega=w, minlevel=4,
dense_coarse_max=0, coarsest_relax=40-N) (its correction() then relaxes
16^2 for N + (40-N) sweeps).  The state carries over via
state_from_numpy.  Tolerance: 1e-9 relative on U, V and P, in float64.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.models.simulation import Simulation as JSimulation  # noqa: E402
from gerris_tpu.models.simulation import Time as JTime  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            state_from_numpy)

from test_bench_schedule import cavity_cfg  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
RTOL = 1e-9


def _jax_params(p):
    """JAX CPU params that run the port's effective schedule ``p``."""
    return jpoisson.MultilevelParams(
        ncycles=1, nrelax=p.nrelax, omega=p.omega, minlevel=4,
        dense_coarse_max=0, coarsest_relax=p.coarsest_relax - p.nrelax)


def _configs(level=6):
    bench = cavity_cfg(level)
    tcfg = config_from_jax(bench)
    jcfg = dataclasses.replace(
        bench, projection=_jax_params(tcfg.projection),
        approx_projection=_jax_params(tcfg.approx_projection),
        diffusion_params=_jax_params(tcfg.diffusion_params))
    return jcfg, tcfg


def _rel(a, b):
    a = np.asarray(a)
    return float(np.max(np.abs(a - b.cpu().numpy())) / np.max(np.abs(a)))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_step_cache():
    """Drop this module's compiled JAX steps when it ends: other files on
    the same test worker count ns_step's jit cache entries
    (tests/test_rigid.py)."""
    yield
    jns.ns_step.clear_cache()


def _jax_step(state, dt, t, cfg, first_step):
    """The JAX ns_step run eagerly (jax.disable_jit): the first eager step
    of a process takes ~20 s (its primitives compile once), each later
    one ~2 s, where compiling the jitted step took ~120 s on the CPU."""
    with jax.disable_jit():
        return jns.ns_step(state, dt, t, cfg, first_step=first_step)


class _JSim(JSimulation):
    """The JAX Simulation with the step's VOF sweep-direction argument left
    at its default and its step run eagerly (_jax_step)."""

    def _advance(self):
        self.state = _jax_step(self.state, self.dt, self.time.t, self.cfg,
                               self.time.i == 0)


def _ns_state():
    rng = np.random.default_rng(0)
    return {n: 0.05 * rng.standard_normal((64, 64)) for n in NAMES}


def _jax_ns_steps():
    """The JAX side of test_ns_step_matches_jax: 10 eager steps."""
    jcfg, _ = _configs()
    js = _ns_state()
    dt = 0.8 * jcfg.grid.h
    for i in range(10):
        js = _jax_step(js, dt, 0.0, jcfg, i == 0)
    return {n: js[n] for n in ("U", "V", "P")}


def test_ns_step_matches_jax():
    """10 lid-cavity steps at 64^2 from a small random state (seeded
    numpy), fixed dt = 0.8 h, against the JAX package's eager steps
    pinned by tools/jax_pins.py (ns_steps)."""
    ref = jax_pins.load("ns_steps")
    _, tcfg = _configs()
    assert tcfg.projection == tpoisson.MultilevelParams(
        nrelax=5, omega=1.5, coarsest_relax=40, ncycles=1)
    assert tcfg.diffusion_params == tpoisson.MultilevelParams(
        nrelax=1, omega=1.0, coarsest_relax=40, ncycles=1)
    ts = state_from_numpy(_ns_state(), device="cpu")
    dt = 0.8 * tcfg.grid.h
    for i in range(10):
        ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=i == 0)
    for n in ("U", "V", "P"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))


def _div_in_src_state():
    rng = np.random.default_rng(1)
    return {n: 0.05 * rng.standard_normal((64, 64)) for n in NAMES}


def _jax_div_in_src():
    """The JAX side of test_ns_step_div_in_src_matches_jax: 4 eager
    steps of its jnp route of the config."""
    jcfg, _ = _configs()
    jcfg = dataclasses.replace(jcfg, div_in_src=True)
    js = _div_in_src_state()
    dt = 0.8 * jcfg.grid.h
    for i in range(4):
        js = _jax_step(js, dt, 0.0, jcfg, i == 0)
    return {n: js[n] for n in ("U", "V", "P")}


def test_ns_step_div_in_src_matches_jax():
    """div_in_src: the port folds each projection's divergence into K6 and
    K9; the JAX CPU step takes its jnp route of the same config, run
    eagerly (jax.disable_jit) so that this config costs no compile of
    the jitted step, pinned by tools/jax_pins.py (ns_div_in_src).  4
    steps at 64^2, fixed dt = 0.8 h."""
    ref = jax_pins.load("ns_div_in_src")
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, div_in_src=True)
    tcfg = dataclasses.replace(tcfg, div_in_src=True)
    assert config_from_jax(jcfg).div_in_src
    ts = state_from_numpy(_div_in_src_state(), device="cpu")
    dt = 0.8 * jcfg.grid.h
    for i in range(4):
        ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=i == 0)
    for n in ("U", "V", "P"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))


def test_entry_points_default_to_the_card(monkeypatch):
    """Simulation and state_from_numpy run on the CUDA card unless the
    caller names a device; without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy({"U": np.zeros((4, 4))})
    assert Simulation(tcfg, device="cpu").device == torch.device("cpu")


def _jax_simulation():
    """The JAX side of test_simulation_run_matches_jax: init + 4 eager
    steps, the time and U at (0, 0.5)."""
    jcfg, _ = _configs()
    jsim = _JSim(jcfg, time=JTime(end=300.0, dtmax=1.0)).init()
    with jax.disable_jit():
        jsim.run(max_steps=4)
    return {**{n: jsim.state[n] for n in ("U", "V", "P")},
            "i": jsim.time.i, "t": jsim.time.t,
            "u_probe": jsim.interpolate("U", (0.0, 0.5))}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"ns_steps": _jax_ns_steps, "ns_div_in_src": _jax_div_in_src,
            "ns_simulation": _jax_simulation}


def test_simulation_run_matches_jax():
    """Simulation.init + run (initial projection, CFL timesteps) for
    4 steps against the JAX Simulation's, pinned by tools/jax_pins.py
    (ns_simulation).  dtmax as in tests/test_lid.py: from rest the CFL
    timestep is unbounded, so the first step would otherwise span the
    whole run."""
    ref = jax_pins.load("ns_simulation")
    _, tcfg = _configs()
    tsim = Simulation(tcfg, time=Time(end=300.0, dtmax=1.0), device="cpu",
                      dtype=torch.float64).init()
    rbgs.reset_launch_counts()
    tsim.run(max_steps=4)
    assert tsim.time.i == int(ref["i"]) == 4
    assert abs(tsim.time.t - float(ref["t"])) <= 1e-12 * abs(float(ref["t"]))
    for n in ("U", "V", "P"):
        assert _rel(ref[n], tsim.state[n]) <= RTOL, n
    # CPU tensors take the plain versions: no kernel launched
    assert all(v == 0 for v in rbgs.LAUNCHES.values()), rbgs.LAUNCHES
    u = float(tsim.interpolate("U", (0.0, 0.5)))
    assert u == pytest.approx(float(ref["u_probe"]), rel=RTOL)


def test_adaptive_and_other_solvers_raise():
    """The adaptive loop runs (it raised before the adaptive slice); the
    cg and mgcg registry solvers, which raised before slice 3c, solve to
    their tolerance; an unknown solver name raises."""
    _, tcfg = _configs()
    sim = Simulation(tcfg, device="cpu").init()
    grid = tcfg.grid
    u = torch.zeros(grid.shape, dtype=torch.float64)
    rhs = torch.from_numpy(np.random.default_rng(2).standard_normal(
        grid.shape))
    rhs = rhs - rhs.mean()
    adaptive = tpoisson.MultilevelParams(dense_coarse_max=1024)
    _, stats = tpoisson.solve(u, rhs, grid, tcfg.p_bc, adaptive)
    assert 1 <= stats.niter < adaptive.nitermax
    assert float(stats.residual_after["infty"]) <= \
        adaptive.tolerance * float(rhs.abs().max())
    for name in ("cg", "mgcg"):
        p = tpoisson.MultilevelParams(solver=name, dense_coarse_max=1024)
        _, st = tpoisson.solve(u, rhs, grid, tcfg.p_bc, p)
        # cg's cap is 20 x nitermax iterations
        assert 1 <= st.niter < p.nitermax * (20 if name == "cg" else 1)
        assert float(st.residual_after["infty"]) <= \
            p.tolerance * float(rhs.abs().max())
    with pytest.raises(ValueError):
        tpoisson.solve(u, u, grid, tcfg.p_bc,
                       tpoisson.MultilevelParams(solver="hypre"))
    st = tns.initial_projection(sim.state, 0.01, 0.0, dataclasses.replace(
        tcfg, approx_projection=adaptive))
    assert all(bool(torch.isfinite(v).all()) for v in st.values())
