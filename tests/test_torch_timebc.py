"""Time-dependent BC values on the port's step against ``gerris_tpu`` on
the CPU in float64.

A callable Dirichlet or Neumann value f(x, y, t) is evaluated at the
step's time t on every torch route: ``apply_bc`` with and without
corners, ``apply_face_bc``, and so the predictor, the advection, the
face interpolation, the projections' corrections and the diffusion's
residual.  The kernels take constant values only, so a component with a
callable value takes its kernels' plain versions, chosen from the
configuration.  The JAX step runs eagerly (``jax.disable_jit``), as in
tests/test_torch_twophase.py."""
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

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg, predict  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import state_from_numpy  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")


def lid_jax(x, y, t):
    return jnp.minimum(t, 1.0) + 0.0 * x


def lid_torch(x, y, t):
    return min(t, 1.0) + 0.0 * x


def _cavity(fbc_mod, lid, level=6):
    """The lid cavity (nu 1e-3, beta 1) whose lid speed is lid(x, y, t),
    the default adaptive schedules with the JAX CPU path's dense coarse
    cap, so both packages run the same sweeps."""
    d0 = fbc_mod.Dirichlet(0.0)
    u_bc = fbc_mod.FieldBC.make(2, left=d0, right=d0, bottom=d0,
                                top=fbc_mod.Dirichlet(lid))
    v_bc = fbc_mod.FieldBC.uniform(d0, 2)
    return u_bc, v_bc


def _configs(level=6):
    kw = dict(dense_coarse_max=1024)
    u, v = _cavity(jbc, lid_jax)
    jcfg = jns.NSConfig(
        grid=JGrid(level=level), u_bcs=(u, v), nu=1e-3, beta=1.0,
        projection=jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                             **kw),
        approx_projection=jpoisson.MultilevelParams(tolerance=1e-3,
                                                    nitermax=100, **kw),
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-3,
                                                   nitermax=10, **kw))
    u, v = _cavity(tbc, lid_torch)
    tcfg = tns.NSConfig(
        grid=TGrid(level=level), u_bcs=(u, v), nu=1e-3, beta=1.0,
        projection=tpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                             **kw),
        approx_projection=tpoisson.MultilevelParams(tolerance=1e-3,
                                                    nitermax=100, **kw),
        diffusion_params=tpoisson.MultilevelParams(tolerance=1e-3,
                                                   nitermax=10, **kw))
    return jcfg, tcfg


def _rel(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _jax_lid_ramp():
    """The JAX side of test_lid_ramp_steps_match_jax: 5 eager steps from
    t = 0.96, and every solve's niter."""
    jcfg, _ = _configs()
    grid = jcfg.grid
    js = {n: jnp.zeros(grid.shape) for n in NAMES}
    dt = 0.8 * grid.h
    t = 0.96
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        for i in range(5):
            js = jns.ns_step(js, dt, t, jcfg, first_step=i == 0)
            t += dt
    return {**{n: js[n] for n in ("U", "V", "P")}, "niter": np.asarray(rec)}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"timebc_lid_ramp": _jax_lid_ramp}


def test_lid_ramp_steps_match_jax(monkeypatch):
    """5 steps of the cavity whose lid speed is min(t, 1) at 64^2 from
    rest, t advancing from 0.96 by dt = 0.8 h (so the ramp ends inside
    the run): U, V and mean-free P within 1e-9 of max and the same niter
    per solve, against the JAX package's eager run pinned by
    tools/jax_pins.py (timebc_lid_ramp).  The U component takes the
    plain versions of K6, K14 and K9 (its value is callable), V its
    kernels' routes."""
    ref = jax_pins.load("timebc_lid_ramp")
    _, tcfg = _configs()
    assert bcg.face_specs(tcfg.u_bcs) is None
    assert bcg.advect_spec(tcfg.u_bcs[0]) is None
    assert bcg.advect_spec(tcfg.u_bcs[1]) is not None
    grid = tcfg.grid
    ts = state_from_numpy({n: np.zeros(grid.shape) for n in NAMES},
                          device="cpu")
    dt = 0.8 * grid.h
    rec = []
    real = tpoisson.solve

    def spy(*args, **kw):
        out = real(*args, **kw)
        rec.append(int(out[1].niter))
        return out

    monkeypatch.setattr(tpoisson, "solve", spy)
    t = 0.96
    for i in range(5):
        ts = tns.ns_step(ts, dt, t, tcfg, first_step=i == 0)
        t += dt
    assert rec == list(ref["niter"]) and len(rec) == 20
    for n in ("U", "V"):
        assert _rel(ref[n], ts[n]) <= 1e-9, (n, _rel(ref[n], ts[n]))
    p_j = ref["P"] - ref["P"].mean()
    p_t = ts["P"] - ts["P"].mean()
    assert _rel(p_j, p_t) <= 1e-9
    # the lid moved the fluid at the ramp's speed: the top row's U
    # approaches min(t, 1) = 1 from below
    assert 0.2 < float(ts["U"][:, -1].max()) < 1.0


def _callable_bcs():
    jf = jbc.FieldBC(((jbc.Dirichlet(lambda x, y, t: x * y + t),
                       jbc.Neumann(lambda x, y, t: jnp.sin(y) * t)),
                      (jbc.Dirichlet(lambda x, y, t: 2.0 * x - t),
                       jbc.Dirichlet(3.0))))
    tf = tbc.FieldBC(((tbc.Dirichlet(lambda x, y, t: x * y + t),
                       tbc.Neumann(lambda x, y, t: torch.sin(y) * t)),
                      (tbc.Dirichlet(lambda x, y, t: 2.0 * x - t),
                       tbc.Dirichlet(3.0))))
    return jf, tf


@pytest.mark.parametrize("axis", [0, 1])
def test_apply_face_bc_callable_matches_jax(axis):
    """apply_face_bc with callable Dirichlet values at t = 0.3 on a 16 x
    32 box: the boundary faces hold f at their centres and time, the
    others stay, bit for bit the reference's."""
    jgrid = JGrid(level=4, dim=2, origin=(0.0, 0.0), extents=(1, 2))
    tgrid = TGrid(level=4, dim=2, origin=(0.0, 0.0), extents=(1, 2))
    jf, tf = _callable_bcs()
    f = np.random.default_rng(2).standard_normal(jgrid.face_shape(axis))
    want = np.asarray(jbc.apply_face_bc(jnp.asarray(f), jgrid, jf, axis,
                                        t=0.3))
    got = tbc.apply_face_bc(torch.from_numpy(f.copy()), tgrid, tf, axis,
                            t=0.3).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, f)


@pytest.mark.parametrize("corners", [True, False])
@pytest.mark.parametrize("width", [1, 2])
def test_apply_bc_callable_matches_jax(corners, width):
    """apply_bc with callable Dirichlet and Neumann values at t = 0.7 on a
    16 x 32 box, with and without corner ghosts: the reference's padding
    (its corners=False route evaluates the values on the unpadded
    field's face centres)."""
    jgrid = JGrid(level=4, dim=2, origin=(0.0, 0.0), extents=(1, 2))
    tgrid = TGrid(level=4, dim=2, origin=(0.0, 0.0), extents=(1, 2))
    jf, tf = _callable_bcs()
    u = np.random.default_rng(4).standard_normal(jgrid.shape)
    want = np.asarray(jbc.apply_bc(jnp.asarray(u), jgrid, jf, width, t=0.7,
                                   corners=corners))
    got = tbc.apply_bc(torch.from_numpy(u), tgrid, tf, width, t=0.7,
                       corners=corners).numpy()
    if corners:
        assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))
    else:
        # the reference leaves corner ghosts zero there; the port's hold
        # edge values, and no axis-separable stencil reads them
        inner = [slice(width, -width), slice(None)]
        for ax in range(2):
            sl = tuple(inner[::-1] if ax else inner)
            assert np.max(np.abs(got[sl] - want[sl])) <= \
                1e-15 * np.max(np.abs(want))


def test_plain_routes_take_t():
    """The plain versions of K6 and K14 evaluate a callable lid at the time
    they are given: at t = 0 and t = 0.5 their outputs differ by the
    lid's change (the lid is U's y ghost: K6's transverse term, K14's y
    faces), and only near the lid."""
    _, tcfg = _configs(level=4)
    grid = tcfg.grid
    rng = np.random.default_rng(7)
    U, V = (torch.from_numpy(rng.standard_normal(grid.shape))
            for _ in range(2))
    ufx, ufy = (torch.from_numpy(rng.standard_normal(grid.face_shape(a)))
                for a in range(2))
    outs = []
    for t in (0.0, 0.5):
        faces = predict.predict_xy_plain(U, V, 0.01, grid, tcfg.u_bcs, t=t)
        fv = bcg.advect2d_plain(U, 0, ufx, ufy, 0.01, grid, tcfg.u_bcs[0],
                                t=t)
        outs.append((faces[0], fv))
    for a, b in zip(*outs):
        assert not torch.equal(a, b)
        assert torch.equal(a[:, :-2], b[:, :-2])
