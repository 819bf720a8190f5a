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


class _JSim(JSimulation):
    """The JAX Simulation with the step's VOF sweep-direction argument left
    at its default, so both tests share one compiled ns_step."""

    def _advance(self):
        self.state = jns.ns_step(self.state, self.dt, self.time.t, self.cfg,
                                 first_step=self.time.i == 0)


def test_ns_step_matches_jax():
    """10 lid-cavity steps at 64^2 from a small random state (seeded
    numpy), fixed dt = 0.8 h."""
    jcfg, tcfg = _configs()
    assert tcfg.projection == tpoisson.MultilevelParams(
        nrelax=5, omega=1.5, coarsest_relax=40, ncycles=1)
    assert tcfg.diffusion_params == tpoisson.MultilevelParams(
        nrelax=1, omega=1.0, coarsest_relax=40, ncycles=1)
    rng = np.random.default_rng(0)
    st = {n: 0.05 * rng.standard_normal(jcfg.grid.shape) for n in NAMES}
    js = {n: np.asarray(v) for n, v in st.items()}
    ts = state_from_numpy(st, device="cpu")
    dt = 0.8 * jcfg.grid.h
    for i in range(10):
        js = jns.ns_step(js, dt, 0.0, jcfg, first_step=i == 0)
        ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=i == 0)
    for n in ("U", "V", "P"):
        assert _rel(js[n], ts[n]) <= RTOL, (n, _rel(js[n], ts[n]))


def test_ns_step_div_in_src_matches_jax():
    """div_in_src: the port folds each projection's divergence into K6 and
    K9; the JAX CPU step takes its jnp route of the same config, run
    eagerly (jax.disable_jit) so that this config costs no compile of
    the jitted step.  4 steps at 64^2, fixed dt = 0.8 h."""
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, div_in_src=True)
    tcfg = dataclasses.replace(tcfg, div_in_src=True)
    assert config_from_jax(jcfg).div_in_src
    rng = np.random.default_rng(1)
    st = {n: 0.05 * rng.standard_normal(jcfg.grid.shape) for n in NAMES}
    js = dict(st)
    ts = state_from_numpy(st, device="cpu")
    dt = 0.8 * jcfg.grid.h
    for i in range(4):
        with jax.disable_jit():
            js = jns.ns_step(js, dt, 0.0, jcfg, first_step=i == 0)
        ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=i == 0)
    for n in ("U", "V", "P"):
        assert _rel(js[n], ts[n]) <= RTOL, (n, _rel(js[n], ts[n]))


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


def test_simulation_run_matches_jax():
    """Simulation.init + run (initial projection, CFL timesteps) for
    4 steps.  dtmax as in tests/test_lid.py: from rest the CFL timestep
    is unbounded, so the first step would otherwise span the whole run."""
    jcfg, tcfg = _configs()
    jsim = _JSim(jcfg, time=JTime(end=300.0, dtmax=1.0)).init()
    jsim.run(max_steps=4)
    tsim = Simulation(tcfg, time=Time(end=300.0, dtmax=1.0), device="cpu",
                      dtype=torch.float64).init()
    rbgs.reset_launch_counts()
    tsim.run(max_steps=4)
    assert tsim.time.i == jsim.time.i == 4
    assert abs(tsim.time.t - jsim.time.t) <= 1e-12 * abs(jsim.time.t)
    for n in ("U", "V", "P"):
        assert _rel(jsim.state[n], tsim.state[n]) <= RTOL, n
    # CPU tensors take the plain versions: no kernel launched
    assert all(v == 0 for v in rbgs.LAUNCHES.values()), rbgs.LAUNCHES
    u = float(tsim.interpolate("U", (0.0, 0.5)))
    assert u == pytest.approx(float(jsim.interpolate("U", (0.0, 0.5))),
                              rel=RTOL)


def test_adaptive_and_other_solvers_raise():
    _, tcfg = _configs()
    sim = Simulation(tcfg, device="cpu").init()
    grid = tcfg.grid
    u = torch.zeros(grid.shape, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tpoisson.solve(u, u, grid, tcfg.p_bc,
                       tpoisson.MultilevelParams(ncycles=0))
    with pytest.raises(NotImplementedError):
        tpoisson.solve(u, u, grid, tcfg.p_bc,
                       tpoisson.MultilevelParams(solver="cg"))
    adaptive = dataclasses.replace(
        tcfg, approx_projection=tpoisson.MultilevelParams(ncycles=0))
    with pytest.raises(NotImplementedError):
        tns.initial_projection(sim.state, 0.01, 0.0, adaptive)
