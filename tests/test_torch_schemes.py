"""The advection schemes the port takes beside the centred Godunov one:
the van Leer and minmod slopes, the non-advected scheme (``scheme=
"none"``) and ``gc=False``, against ``gerris_tpu`` on the CPU in float64.

Under a limiter or ``scheme="none"`` the predictor and the advections
take the reference's generic route (``bcg.applicable`` is False, as in
gerris_tpu/ops/pallas/bcg.py:450-452): no kernel, and no kernel twin,
since those compute the centred Godunov scheme only.  Inputs are made
with numpy from a seed; the functions agree to rounding (1e-13 of max),
the steps to 1e-9 with equal niter per solve."""
import dataclasses
import functools
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
from gerris_tpu.solvers import advection as jadv  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs  # noqa: E402
from gerris_tpu_torch.solvers import advection as tadv  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            fieldbc_from_jax, grid_from_jax,
                                            state_from_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

GRADIENTS = ("centered", "van_leer", "minmod")
SCHEMES = ("godunov", "none")
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
FN_RTOL = 1e-13
RTOL = 1e-9


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mixed_bc():
    """Dirichlet 0.3 left, Neumann -0.2 right, Dirichlet 0 bottom,
    Neumann 0 top: every ghost formula on one field."""
    return jbc.FieldBC(((jbc.Dirichlet(0.3), jbc.Neumann(-0.2)),
                        (jbc.Dirichlet(0.0), jbc.Neumann(0.0))))


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


@pytest.mark.parametrize("gradient", GRADIENTS)
def test_slope_matches_jax(gradient):
    """_slope on a random padded array, both axes, with exact zeros and
    sign changes (where the limiters switch), bit for bit."""
    rng = np.random.default_rng(0)
    a = np.round(rng.standard_normal((18, 20)), 1)
    for axis in range(2):
        ref = np.asarray(jadv._slope(jnp.asarray(a), axis, gradient))
        got = tadv._slope(_t(a), axis, gradient).numpy()
        assert np.array_equal(ref, got), (gradient, axis)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("gradient", GRADIENTS)
def test_advected_face_values_match_jax(gradient, scheme):
    """advected_face_values of a random field with mixed BCs and a random
    advecting velocity at 24 x 32, per axis and side."""
    rng = np.random.default_rng(1)
    jg = JGrid(level=5, dim=2)
    tg = grid_from_jax(jg)
    v = rng.standard_normal(jg.shape)[:, :]
    uc = [rng.standard_normal((34, 34)) for _ in range(2)]
    jpar = jadv.AdvectionParams(gradient=gradient, scheme=scheme)
    tpar = tadv.AdvectionParams(gradient=gradient, scheme=scheme)
    fbc = _mixed_bc()
    ref = jadv.advected_face_values(jnp.asarray(v), jg, fbc, 0.01, jpar,
                                    [jnp.asarray(u) for u in uc])
    got = tadv.advected_face_values(_t(v), tg, fieldbc_from_jax(fbc), 0.01,
                                    [_t(u) for u in uc], par=tpar)
    for (rp, rm), (gp, gm) in zip(ref, got):
        assert _rel(rp, gp) <= FN_RTOL and _rel(rm, gm) <= FN_RTOL


def test_advection_params_take_the_schemes():
    """AdvectionParams takes the limiters, scheme "none" and gc=False;
    an unknown name raises; only the centred Godunov scheme is the
    kernels' (bcg.applicable)."""
    grid = grid_from_jax(JGrid(level=5))
    assert bcg.applicable(grid, tadv.AdvectionParams())
    for kw in (dict(gradient="van_leer"), dict(gradient="minmod"),
               dict(scheme="none")):
        assert not bcg.applicable(grid, tadv.AdvectionParams(**kw))
    assert bcg.applicable(grid, tadv.AdvectionParams(gc=False))
    with pytest.raises(ValueError):
        tadv.AdvectionParams(gradient="superbee")
    with pytest.raises(ValueError):
        tadv.AdvectionParams(scheme="weno")


def _cavity(level, **adv):
    """The lid cavity at ``level`` with the given advection parameters and
    an adaptive schedule (tolerance 1e-3, 8^2 dense coarsest level) that
    the JAX CPU path runs as it is."""
    grid = JGrid(level=level, dim=2)
    u_bc = jbc.FieldBC.make(2, default=jbc.Dirichlet(0.0),
                            top=jbc.Dirichlet(1.0))
    v_bc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    mp = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                   dense_coarse_max=64)
    jcfg = jns.NSConfig(
        grid=grid, u_bcs=(u_bc, v_bc), nu=1e-3, beta=1.0,
        advection=jadv.AdvectionParams(**adv), projection=mp,
        approx_projection=mp,
        diffusion_params=dataclasses.replace(mp, nitermax=10))
    tcfg = config_from_jax(jcfg)
    # config_from_jax applies the TPU's floors, which the JAX CPU path
    # does not: give the port the JAX params as they are
    tp = tpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                   dense_coarse_max=64)
    return jcfg, dataclasses.replace(
        tcfg, projection=tp, approx_projection=tp,
        diffusion_params=dataclasses.replace(tp, nitermax=10))


@pytest.mark.parametrize("adv", [dict(scheme="none"),
                                 dict(gradient="van_leer"),
                                 dict(gradient="minmod", gc=False)])
def test_predictor_and_advection_match_jax(monkeypatch, adv):
    """The generic predictor (predicted_face_velocities) and the generic
    momentum advection-diffusion of random velocities at 32^2 under a
    limiter or scheme "none", with random gmac and g_prev: no kernel or
    kernel twin runs (each is spied), and the faces and velocities
    match."""
    jcfg, tcfg = _cavity(5, **adv)
    rng = np.random.default_rng(2)
    U = [rng.standard_normal(jcfg.grid.shape) * 0.3 for _ in range(2)]
    gm = [rng.standard_normal(jcfg.grid.shape) for _ in range(2)]
    gp = [rng.standard_normal(jcfg.grid.shape) for _ in range(2)]
    dt = 0.4 * jcfg.grid.h
    called = []
    for mod, names in ((predict, ("predict_xy", "predict_xy_plain")),
                       (bcg, ("advect2d", "advect2d_plain",
                              "advect2d_pair"))):
        for n in names:
            monkeypatch.setattr(mod, n, lambda *a, _n=n, **k:
                                called.append(_n))
    juf = jns.predicted_face_velocities([jnp.asarray(u) for u in U],
                                        jcfg.grid, jcfg, dt, 0.0)
    tuf, divp = tns.predicted_face_velocities([_t(u) for u in U],
                                              tcfg.grid, tcfg, dt)
    assert divp is None
    for a, b in zip(juf, tuf):
        assert _rel(a, b) <= FN_RTOL
    gc = adv.get("gc", True)
    jout = jns.velocity_advection_diffusion(
        [jnp.asarray(u) for u in U], juf, [jnp.asarray(g) for g in gm],
        [jnp.asarray(g) for g in gp] if gc else None, jcfg.grid, jcfg, dt,
        0.0)
    tout = tns.velocity_advection_diffusion(
        [_t(u) for u in U], tuf, [_t(g) for g in gm],
        [_t(g) for g in gp] if gc else None, tcfg.grid, tcfg, dt)
    assert called == []
    for a, b in zip(jout, tout):
        assert _rel(a, b) <= RTOL


CAVITY_ADV = {"none": dict(scheme="none", gc=False),
              "van_leer": dict(gradient="van_leer")}


def _cavity_case(adv):
    jcfg, tcfg = _cavity(5, **adv)
    names = NAMES if adv.get("gc", True) else NAMES[:4]
    rng = np.random.default_rng(3)
    st = {n: 0.05 * rng.standard_normal(jcfg.grid.shape) for n in names}
    return jcfg, tcfg, names, st


def _jax_cavity(adv):
    """The JAX side of test_cavity_steps_match_jax: the initial projection
    and 4 eager steps, and every solve's niter."""
    jcfg, _, _, st = _cavity_case(adv)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    dt = 0.5 * jcfg.grid.h
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        js = jns.initial_projection(js, dt, 0.0, jcfg)
        for i in range(4):
            js = jns.ns_step(js, dt, i * dt, jcfg, first_step=i == 0)
    return {**dict(js), "niter": np.asarray(rec)}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {f"schemes_cavity_{k}": functools.partial(_jax_cavity, adv)
            for k, adv in CAVITY_ADV.items()}


@pytest.mark.parametrize("adv", list(CAVITY_ADV.values()))
def test_cavity_steps_match_jax(monkeypatch, adv):
    """4 lid-cavity steps at 32^2 from a small random state (seeded
    numpy), dt = 0.5 h: U, V and mean-free P within 1e-9 and the niter
    of every solve, against the JAX package's run pinned by
    tools/jax_pins.py (schemes_cavity_none, schemes_cavity_van_leer).
    With gc=False the state keeps no gradients: the step reads none and
    writes none back."""
    name = next(k for k, v in CAVITY_ADV.items() if v == adv)
    ref = jax_pins.load(f"schemes_cavity_{name}")
    jcfg, tcfg, names, st = _cavity_case(adv)
    ts = state_from_numpy(st, device="cpu")
    dt = 0.5 * jcfg.grid.h
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    projops.reset_launch_counts()
    ts = tns.initial_projection(ts, dt, 0.0, tcfg)
    for i in range(4):
        ts = tns.ns_step(ts, dt, i * dt, tcfg, first_step=i == 0)
    assert trec == list(ref["niter"]) and len(trec) == 17, (trec, ref)
    assert set(ts) == set(ref) - {"niter"} == set(names)
    for n in ("U", "V"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
