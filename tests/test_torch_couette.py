"""The cylindrical Couette flow (the reference's test/couette,
tests/test_couette.py) on the port against the JAX package on the CPU in
float64: a solid annulus with a callable surface velocity (the inner
cylinder turning), Neumann pressure (so the projections remove the
fluid-volume-weighted mean), scheme "none".

chip_smoke.couette_cfg at level 4 (16^2), from a seeded small velocity,
dt 1e-2: the initial projection and one ns_step on both (the JAX step
eagerly under jax.disable_jit, the only JAX step of this file), U, V,
Gx, Gy and the mean-free P and Pmac within 1e-10 of max.  The profile
gate at level 6 runs on the card (chip_smoke.couette_gate); here its
level-5 run on the port."""
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
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-10
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
MID2 = 0.375 ** 2


def _jphi(x, y):
    r2 = x * x + y * y
    return jnp.minimum(chip_smoke.COUETTE_R[1] ** 2 - r2,
                       r2 - chip_smoke.COUETTE_R[0] ** 2)


def couette_jcfg(level):
    """tests/test_couette.py:test_couette_profile's NSConfig."""
    mp = jpoisson.MultilevelParams(tolerance=1e-6, nitermax=100)
    return jns.NSConfig(
        grid=JGrid(level), u_bcs=(jbc.velocity_bc(0, 2),
                                  jbc.velocity_bc(1, 2)),
        nu=1.0, beta=1.0, solid_phi=_jphi,
        surface_u=(lambda x, y: jnp.where(x * x + y * y > MID2, 0.0, -y),
                   lambda x, y: jnp.where(x * x + y * y > MID2, 0.0, x)),
        advection=jns.adv.AdvectionParams(scheme="none"),
        approx_projection=mp, projection=mp,
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-6,
                                                   nitermax=30))


def _rel(a, b, mean_free=False):
    a, b = np.asarray(a), b.numpy()
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_step_cache():
    yield
    jns.ns_step.clear_cache()
    jns.initial_projection.clear_cache()


def _couette_state(shape):
    rng = np.random.default_rng(3)
    return {n: 0.01 * rng.standard_normal(shape) for n in NAMES}


def _jax_couette():
    """The JAX side of test_couette_step_matches_jax: the initial
    projection and one eager step."""
    jcfg = couette_jcfg(4)
    st = _couette_state(jcfg.grid.shape)
    dt = 1e-2
    with jax.disable_jit():
        j0 = jns.initial_projection({k: jnp.asarray(v) for k, v in
                                     st.items()}, dt, 0.0, jcfg)
        j1 = jns.ns_step(j0, dt, 0.0, jcfg, cstart=0, first_step=True)
    return {**{f"init_{n}": j0[n] for n in NAMES},
            **{f"step_{n}": j1[n] for n in NAMES}}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"couette_step": _jax_couette}


def test_couette_step_matches_jax():
    """The initial projection and one step of the Couette flow at level 4
    against the JAX package's eager run pinned by tools/jax_pins.py
    (couette_step): every field (P, Pmac mean-free) within RTOL."""
    ref = jax_pins.load("couette_step")
    tcfg = chip_smoke.couette_cfg(4)
    st = _couette_state(tcfg.grid.shape)
    dt = 1e-2
    t0 = tns.initial_projection(convert.state_from_numpy(st, device="cpu"),
                                dt, 0.0, tcfg)
    t1 = tns.ns_step(t0, dt, 0.0, tcfg, first_step=True, cstart=0)
    for phase, got in (("init", t0), ("step", t1)):
        for n in NAMES:
            assert _rel(ref[f"{phase}_{n}"], got[n],
                        n in ("P", "Pmac")) <= RTOL, (phase, n)
    # the turning inner cylinder drives the fluid next to it
    assert float(t1["V"].abs().max()) > 0.1


def test_couette_config_is_the_tests():
    """chip_smoke.couette_cfg, the card gate's configuration, is the test's,
    carried over with its level set's and surface velocities' torch
    counterparts."""
    ours = chip_smoke.couette_cfg(4)
    conv = convert.config_from_jax(
        couette_jcfg(4), solid_phi=chip_smoke.couette_phi,
        surface_u=(chip_smoke.couette_us_u, chip_smoke.couette_us_v))
    for f in ("grid", "u_bcs", "p_bc", "nu", "beta", "advection",
              "solid_phi", "surface_u"):
        assert getattr(ours, f) == getattr(conv, f), f
    for f in ("projection", "approx_projection", "diffusion_params"):
        a, b = getattr(ours, f), getattr(couette_jcfg(4), f)
        assert (a.tolerance, a.nitermax, a.nrelax) == \
            (b.tolerance, b.nitermax, b.nrelax), f


def test_couette_profile_level5():
    """The gate's run at level 5 on the port (the card runs level 6): the
    steady tangential velocity within the test's bounds of the analytic
    profile."""
    import io
    from contextlib import redirect_stdout
    with redirect_stdout(io.StringIO()):
        chip_smoke.couette_gate(torch.device("cpu"), "cpu", level=5)
