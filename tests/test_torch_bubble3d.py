"""The 3D rising bubble (Hysing et al.'s test case 1 as Adelsberger et al.
(2014) extended it to 3D) on the port against ``gerris_tpu`` on the CPU
in float64: density, a variable viscosity, a body force and tension on
a box of (1, 2, 1) unit boxes.

The configuration: the box [0, 1] x [0, 2] x [0, 1] (``extents=(1, 2,
1)``, y up), one VOF tracer T (1 in the liquid), density ("T", 1000,
100, 1), the dynamic viscosity mu(T1) = 10 T1 + (1 - T1) of the
once-filtered fraction, gravity (None, -0.98, None), tension 24.5, the
sphere of radius 0.25 at (0.5, 0.5, 0.5), no-slip walls at y = 0 and
y = 2 and free slip on the four others.  The port takes it through
``config_from_jax`` with torch counterparts of the callables; in 3D the
schedules carry over as given (the reference's defaults: adaptive to
1e-3).  The JAX step runs eagerly (``jax.disable_jit``) so that each
solve's niter can be read.  No TPU kernel lies on this path: the face
coefficients and the cell dia take the torch correction and smoother in
both packages."""
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
from gerris_tpu.physics import vof as jvof  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs, rbgs3d  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            state_from_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-9
NAMES = ("U", "V", "W", "P", "Pmac", "Gx", "Gy", "Gz")


def mu_jax(x, y, z, t=0.0, T1=None):
    return 10.0 * T1 + 1.0 * (1.0 - T1)


def mu_torch(x, y, z, t=0.0, T1=None):
    return 10.0 * T1 + 1.0 * (1.0 - T1)


def bubble3d_jcfg(level):
    """The 3D bubble as a JAX NSConfig at ``level`` (2^level cells per
    unit), the reference's default schedules with the dense coarsest
    solve capped at 1024 unknowns (the JAX package's cap on the CPU)."""
    d0, nn = jbc.Dirichlet(0.0), jbc.Neumann()
    # the normal component Dirichlet on its own walls, every component
    # Dirichlet at y = 0 and 2 (no slip), Neumann elsewhere (free slip)
    u_bcs = tuple(jbc.FieldBC(tuple((d0, d0) if a in (c, 1) else (nn, nn)
                                    for a in range(3))) for c in range(3))
    mp = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                   dense_coarse_max=1024)
    return jns.NSConfig(
        grid=JGrid(level=level, dim=3, origin=(0.0, 0.0, 0.0),
                   extents=(1, 2, 1)),
        u_bcs=u_bcs, nu=0.0, beta=1.0,
        vof_tracers=(("T", jbc.default_scalar_bc(3)),),
        tension=(("T", 24.5),), density=("T", 1000.0, 100.0, 1),
        body_force=(None, -0.98, None), nu_var=mu_jax,
        nu_var_fields=(("T1", "T", 1),), projection=mp,
        approx_projection=mp,
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-3,
                                                   nitermax=10,
                                                   dense_coarse_max=1024))


def _bubble_T(grid):
    return np.asarray(jvof.fraction_from_levelset(
        grid, lambda x, y, z: jnp.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2
                                       + (z - 0.5) ** 2) - 0.25))


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
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


def test_config_carries_the_3d_bubble():
    """config_from_jax carries the 3D two-phase NSConfig: the (1, 2, 1)
    box, the density, the force, the viscosity's torch counterpart and
    the schedules as given."""
    tcfg = config_from_jax(bubble3d_jcfg(4), nu_var=mu_torch)
    assert tcfg.grid.shape == (16, 32, 16) and tcfg.grid.extents == (1, 2, 1)
    assert tcfg.density == ("T", 1000.0, 100.0, 1)
    assert tcfg.body_force == (None, -0.98, None)
    assert tcfg.nu_var is mu_torch and tcfg.tension == (("T", 24.5),)
    jp = bubble3d_jcfg(4).projection
    assert (tcfg.projection.nrelax, tcfg.projection.coarsest_relax) == \
        (jp.nrelax, jp.coarsest_relax)


def _bubble3d_state(grid):
    rng = np.random.default_rng(0)
    st = {n: 0.01 * rng.standard_normal(grid.shape) for n in NAMES}
    st["T"] = _bubble_T(grid)
    return st


def _jax_bubble3d():
    """The JAX side of test_bubble3d_step_matches_jax: one eager step, and
    every solve's niter."""
    jcfg = bubble3d_jcfg(4)
    js = {k: jnp.asarray(v) for k, v in _bubble3d_state(jcfg.grid).items()}
    dt = 0.2 * jcfg.grid.h
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        js = jns.ns_step(js, dt, 0.0, jcfg, cstart=0, first_step=True)
    return {**dict(js), "niter": np.asarray(rec)}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"bubble3d_step": _jax_bubble3d}


def test_bubble3d_step_matches_jax(monkeypatch):
    """One step of the bubble at 16 x 32 x 16 from a small random velocity
    (seeded numpy), dt = 0.2 h: U, V, W, T and mean-free P within 1e-9 of
    max, the same niter for every solve (2 projections and 3 diffusions,
    each with the density's face coefficients), the tension's face
    sources non-zero (the curvature is defined on the interface) and no
    kernel launched, against the JAX package's eager step pinned by
    tools/jax_pins.py (bubble3d_step).  (The initial projection is
    compared on the droplet, tests/test_torch_droplet3d.py.)"""
    ref = jax_pins.load("bubble3d_step")
    jcfg = bubble3d_jcfg(4)
    tcfg = config_from_jax(jcfg, nu_var=mu_torch)
    st = _bubble3d_state(jcfg.grid)
    ts = state_from_numpy(st, device="cpu")
    _, alpha = tns.density_fields(ts, tcfg)
    fs = tns.tension_sources(ts, tcfg, alpha=alpha)
    assert all(bool(f.abs().max() > 0.0) for f in fs)
    dt = 0.2 * jcfg.grid.h
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    rbgs3d.reset_launch_counts()
    ts = tns.ns_step(ts, dt, 0.0, tcfg, first_step=True, cstart=0)
    assert len(trec) == 5 and trec == list(ref["niter"]), (trec, ref)
    for n in ("U", "V", "W", "T", "Gx", "Gy", "Gz", "Pmac"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
    assert bool((ts["V"] != torch.from_numpy(st["V"])).any())
    assert all(v == 0 for v in rbgs.LAUNCHES.values())
    assert all(v == 0 for v in rbgs3d.LAUNCHES.values())
