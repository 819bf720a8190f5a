"""Passive tracers (``NSConfig.tracers``, ``advect_tracer``) of the port
against ``gerris_tpu`` on the CPU in float64.

A tracer is (name, FieldBC, D[, source]).  It advances after the
approximate projection with its faces: K14 ``advect2d`` where K14 takes
its BCs under the centred Godunov scheme (on the CPU, K14's plain
version), else the generic route; then dt times its source and, with D
> 0, an implicit diffusion solve (gerris_tpu/models/ns.py:450-483,
:999-1004).  The JAX CPU step always takes the generic route; on walls
the two agree (the corner ghosts, which they order differently, carry
no flux).  Inputs are made with numpy from a seed; bound 1e-9 of max,
equal niter per solve."""
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
from gerris_tpu.models.simulation import Simulation as JSimulation  # noqa: E402
from gerris_tpu.models.simulation import Time as JTime  # noqa: E402
from gerris_tpu.solvers import advection as jadv  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg, rbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            state_from_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-9
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


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


def age_jax(x, y, t):
    return 1.0 + 0.5 * x * y + 0.1 * t


def age_torch(x, y, t):
    return 1.0 + 0.5 * x * y + 0.1 * t


def _cavity(level, tracers, **adv):
    """The lid cavity with ``tracers`` on an adaptive schedule (tolerance
    1e-3, 8^2 dense coarsest level) that the JAX CPU path runs as it is;
    (JAX config, port config)."""
    u_bc = jbc.FieldBC.make(2, default=jbc.Dirichlet(0.0),
                            top=jbc.Dirichlet(1.0))
    v_bc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    mp = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                   dense_coarse_max=64)
    jcfg = jns.NSConfig(
        grid=JGrid(level=level, dim=2), u_bcs=(u_bc, v_bc), nu=1e-3,
        beta=1.0, advection=jadv.AdvectionParams(**adv), projection=mp,
        approx_projection=mp,
        diffusion_params=dataclasses.replace(mp, nitermax=10),
        tracers=tracers)
    tcfg = config_from_jax(jcfg, tracer_sources={"A": age_torch})
    tp = tpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                   dense_coarse_max=64)
    return jcfg, dataclasses.replace(
        tcfg, projection=tp, approx_projection=tp,
        diffusion_params=dataclasses.replace(tp, nitermax=10))


def _faces(grid, rng, scale=0.5):
    """Random MAC faces, zero on the walls."""
    uf = []
    for c in range(2):
        f = scale * rng.standard_normal(grid.face_shape(c))
        idx = [slice(None)] * 2
        for k in (0, -1):
            idx[c] = k
            f[tuple(idx)] = 0.0
        uf.append(f)
    return uf


TRACERS = {
    "neumann": ("C", jbc.default_scalar_bc(2), 0.0),
    "dirichlet_D": ("C", jbc.FieldBC.make(2, left=jbc.Dirichlet(1.0),
                                          right=jbc.Dirichlet(0.0)), 2e-3),
    "source_D": ("C", jbc.default_scalar_bc(2), 1e-3, 1.0),
    "callable_source": ("A", jbc.default_scalar_bc(2), 0.0, age_jax),
}


@pytest.mark.parametrize("gradient", ["centered", "van_leer"])
@pytest.mark.parametrize("case", sorted(TRACERS))
def test_advect_tracer_matches_jax(monkeypatch, case, gradient):
    """advect_tracer of a random tracer with random wall-free faces at
    32^2: on the K14 route (centred; its plain version on the CPU, with
    no face forced) or the generic route (van Leer), with a constant or
    callable source and with D > 0 (one diffusion solve, equal niter)."""
    jtr = TRACERS[case]
    jcfg, tcfg = _cavity(5, (jtr,), gradient=gradient)
    ttr = tcfg.tracers[0]
    rng = np.random.default_rng(4)
    T = rng.random(jcfg.grid.shape)
    uf = _faces(jcfg.grid, rng)
    dt, t = 0.4 * jcfg.grid.h, 0.3
    k14 = []
    real = bcg.advect2d
    monkeypatch.setattr(bcg, "advect2d", lambda *a, **k: (
        k14.append(a[1]), real(*a, **k))[1])
    jrec = _record(monkeypatch, jpoisson)
    trec = _record(monkeypatch, tpoisson)
    ref = jns.advect_tracer(jnp.asarray(T), jtr, [jnp.asarray(u) for u in uf],
                            jcfg.grid, jcfg, dt, t)
    got = tns.advect_tracer(_t(T), ttr, [_t(u) for u in uf], tcfg.grid,
                            tcfg, dt, t)
    assert k14 == ([None] if gradient == "centered" else [])
    assert trec == jrec and len(trec) == (1 if jtr[2] > 0 else 0)
    assert _rel(ref, got) <= RTOL


def test_age_tracer_source():
    """The Age case of tests/test_misc2.py: a unit source and no flow
    gives Age = t after two steps of 0.25."""
    _, tcfg = _cavity(4, (("A", jbc.default_scalar_bc(2), 0.0, 1.0),))
    uf = [torch.zeros(tcfg.grid.face_shape(c), dtype=torch.float64)
          for c in range(2)]
    A = torch.zeros(tcfg.grid.shape, dtype=torch.float64)
    for _ in range(2):
        A = tns.advect_tracer(A, tcfg.tracers[0], uf, tcfg.grid, tcfg, 0.25)
    assert float((A - 0.5).abs().max()) < 1e-12


def test_k14_takes_a_tracer():
    """A tracer's K14 launch forces no face: the launch arguments of c
    None carry mask 0; a Dirichlet tracer's plain version keeps its
    computed boundary faces (the JAX generic route's)."""
    fbc = tbc.FieldBC.make(2, left=tbc.Dirichlet(1.0))
    v = torch.zeros(8, 8, dtype=torch.float64)
    _, _, masks, fb = bcg._launch_args("advect2d", [v], [None], [fbc])
    assert masks == [0] and list(fb) == [0.0, 0.0]
    _, _, masks, _ = bcg._launch_args("advect2d", [v], [0], [fbc])
    assert masks == [1]


def _cavity_tracer_case(gc):
    jtr = ("C", jbc.default_scalar_bc(2), 1e-3)
    jcfg, tcfg = _cavity(5, (jtr,), gc=gc)
    names = NAMES if gc else NAMES[:4]
    rng = np.random.default_rng(5)
    st = {n: 0.05 * rng.standard_normal(jcfg.grid.shape) for n in names}
    st["C"] = np.asarray(jcfg.grid.centers[0]) + 0.5 \
        + np.zeros(jcfg.grid.shape)
    return jcfg, tcfg, st


def _jax_cavity_tracer(gc):
    """The JAX side of test_cavity_with_tracer_matches_jax: 5 eager
    steps, and every solve's niter."""
    jcfg, _, st = _cavity_tracer_case(gc)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    dt = 0.5 * jcfg.grid.h
    with jax.disable_jit(), jax_pins.recording(jpoisson) as rec:
        for i in range(5):
            js = jns.ns_step(js, dt, i * dt, jcfg, first_step=i == 0)
    return {**dict(js), "niter": np.asarray(rec)}


@pytest.mark.parametrize("gc", [False, True])
def test_cavity_with_tracer_matches_jax(monkeypatch, gc):
    """5 lid-cavity steps at 32^2 with a tracer C (D = 1e-3, the default
    scalar BCs, C0 = x + 0.5) and gc off or on, from a small random
    velocity (seeded numpy), dt = 0.5 h: U, V, C and mean-free P within
    1e-9 and the niter of every solve (5 a step with the tracer's),
    against the JAX package's run pinned by tools/jax_pins.py
    (tracers_cavity_gc0, tracers_cavity_gc1)."""
    ref = jax_pins.load(f"tracers_cavity_gc{int(gc)}")
    jcfg, tcfg, st = _cavity_tracer_case(gc)
    ts = state_from_numpy(st, device="cpu")
    dt = 0.5 * jcfg.grid.h
    trec = _record(monkeypatch, tpoisson)
    rbgs.reset_launch_counts()
    for i in range(5):
        ts = tns.ns_step(ts, dt, i * dt, tcfg, first_step=i == 0)
    assert trec == list(ref["niter"]) and len(trec) == 25, (trec, ref)
    assert set(ts) == set(ref) - {"niter"}
    for n in ("U", "V", "C"):
        assert _rel(ref[n], ts[n]) <= RTOL, (n, _rel(ref[n], ts[n]))
    assert _rel(ref["P"], ts["P"], mean_free=True) <= RTOL
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def _sim_tracer():
    return ("C", jbc.FieldBC.make(2, left=jbc.Dirichlet(1.0)), 1e-3)


def _jax_simulation_tracer():
    """The JAX side of test_simulation_takes_tracers: 3 eager steps of the
    JAX Simulation with the tracer C."""
    jcfg, _ = _cavity(4, (_sim_tracer(),), gc=False)
    with jax.disable_jit():
        js = JSimulation(jcfg, time=JTime(dtmax=0.5 * jcfg.grid.h))
        js.init(C=jnp.full(jcfg.grid.shape, 0.25))
        js.run(max_steps=3)
    return dict(js.state)


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"tracers_simulation": _jax_simulation_tracer,
            **{f"tracers_cavity_gc{int(gc)}": functools.partial(
                _jax_cavity_tracer, gc) for gc in (False, True)}}


def test_simulation_takes_tracers():
    """Simulation.init creates each tracer (and the gradients only with
    gc), field_bc gives a tracer's BCs, and a short run matches the JAX
    Simulation's (pinned by tools/jax_pins.py, tracers_simulation)."""
    jcfg, tcfg = _cavity(4, (_sim_tracer(),), gc=False)
    s = Simulation(tcfg, time=Time(dtmax=0.5 * tcfg.grid.h), device="cpu")
    s.init(C=0.25)
    assert set(s.state) == {"U", "V", "P", "Pmac", "C"}
    assert s.field_bc("C") == tcfg.tracers[0][1]
    assert tcfg.tracers[0][1].sides[0][0] == tbc.Dirichlet(1.0)
    s.run(max_steps=3)
    ref = jax_pins.load("tracers_simulation")
    assert set(ref) == set(s.state)
    for n in ("U", "V", "C"):
        assert _rel(ref[n], s.state[n]) <= RTOL
