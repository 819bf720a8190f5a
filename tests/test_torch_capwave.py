"""The capillary wave (the reference's test/capwave, tests/test_capwave.py)
on the port against ``gerris_tpu`` on the CPU in float64: its analytic
amplitude (utils/analytic.prosperetti_capwave), its configuration as
chip_smoke.py builds it for the card, and one step of it on the 1 x 3
box with periodic rows.

The step: level 4 (16 x 48 cells), both projections and the diffusion to
1e-6 as the test gives them; at this size every solve's coarsest level is
the whole level, solved dense on both sides (the JAX package caps the
dense solve at 1024 unknowns on the CPU, the port at 4096), so both run
the same schedule.  The JAX step runs eagerly (``jax.disable_jit``), the
only JAX step of this file.  Tolerance: 1e-10 of max on U, V, T and the
mean-free P."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402
from gerris_tpu.utils.analytic import prosperetti_capwave as jprosp  # noqa

import chip_smoke  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.utils.analytic import prosperetti_capwave  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            state_from_numpy)

RTOL = 1e-10
NU = 0.0182571749236
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")


def capwave_jcfg(level):
    """tests/test_capwave.py:run_level's NSConfig."""
    per = (jbc.Periodic(), jbc.Periodic())
    ubc = jbc.FieldBC((per, (jbc.Neumann(), jbc.Neumann())))
    vbc = jbc.FieldBC((per, (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0))))
    mp = jpoisson.MultilevelParams(tolerance=1e-6, nitermax=100)
    return jns.NSConfig(
        grid=JGrid(level=level, dim=2, origin=(-0.5, -1.5), extents=(1, 3)),
        u_bcs=(ubc, vbc), nu=NU, beta=1.0, vof_tracers=(("T", ubc),),
        tension=(("T", 1.0),), projection=mp, approx_projection=mp,
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-6,
                                                   nitermax=20))


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.numpy()
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_step_cache():
    """Drop this module's compiled JAX steps when it ends: other files on
    the same test worker count ns_step's jit cache entries
    (tests/test_rigid.py)."""
    yield
    jns.ns_step.clear_cache()


def test_prosperetti_matches_jax():
    """The port's copy of the analytic amplitude against the JAX
    package's over the gate's samples, equal densities and a 10:1 pair,
    to 1e-13 of A0."""
    t = np.arange(0.0, 2.2426211256, 3.04290519077e-3 * 7)
    for rho2 in (1.0, 0.1):
        ref = jprosp(t, 0.01, 2 * math.pi, NU, 1.0, 1.0, rho2)
        got = prosperetti_capwave(t, 0.01, 2 * math.pi, NU, 1.0, 1.0, rho2)
        assert np.max(np.abs(ref - got)) <= 1e-13 * 0.01
    # the wave starts at A0 and is damped
    a = prosperetti_capwave([0.0, 2.2426211256], 0.01, 2 * math.pi, NU, 1.0)
    assert a[0] == pytest.approx(0.01, rel=1e-9) and abs(a[1]) < 0.01


def test_capwave_config_is_the_tests():
    """chip_smoke.capwave_cfg, the card's configuration, is
    tests/test_capwave.py's, field for field with the port's converted
    config, up to the schedule: the card runs the port's MultilevelParams
    with the test's tolerances and caps, which the JAX package runs on
    the CPU (config_from_jax gives the TPU's raised nrelax instead)."""
    ours = chip_smoke.capwave_cfg(4)
    conv = config_from_jax(capwave_jcfg(4))
    assert ours.grid == conv.grid and ours.grid.shape == (16, 48)
    for f in ("u_bcs", "p_bc", "nu", "beta", "vof_tracers", "tension",
              "density", "advection"):
        assert getattr(ours, f) == getattr(conv, f), f
    for f in ("projection", "approx_projection", "diffusion_params"):
        a, b = getattr(ours, f), getattr(capwave_jcfg(4), f)
        assert (a.tolerance, a.nitermax, a.nrelax, a.minlevel) == \
            (b.tolerance, b.nitermax, b.nrelax, b.minlevel), f


def test_capwave_step_matches_jax():
    """One step of the capillary wave at level 4 from a small seeded
    velocity, dt = 0.2 h: U, V, T and mean-free P within 1e-10 of the
    JAX step's, and no kernel launched on the CPU."""
    jcfg = capwave_jcfg(4)
    tcfg = chip_smoke.capwave_cfg(4)
    grid = jcfg.grid
    rng = np.random.default_rng(7)
    st = {n: 0.01 * rng.standard_normal(grid.shape) for n in NAMES}
    st["T"] = np.asarray(jvof.fraction_from_levelset(
        grid, lambda x, y: y - 0.01 * jnp.cos(2 * math.pi * x)))
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = state_from_numpy(st, device="cpu")
    dt = 0.2 * grid.h
    rbgs.reset_launch_counts()
    with jax.disable_jit():
        js = jns.ns_step(js, dt, 0.0, jcfg, cstart=0, first_step=True)
    ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=True, cstart=0)
    for n in ("U", "V", "T"):
        assert _rel(js[n], ts[n]) <= RTOL, (n, _rel(js[n], ts[n]))
    assert _rel(js["P"], ts["P"], mean_free=True) <= RTOL
    assert all(v == 0 for v in rbgs.LAUNCHES.values())
