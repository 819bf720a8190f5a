"""The port's U+V pair route on the CPU, float64.

* The plain versions of K7 ``advect2d_pair`` (both modes) and of the
  diffusion pair's K8a ``residual_restrict_pair``, K8b
  ``cascade_prolong_relax_pair`` and K8c ``prolong_relax_pair`` against
  the JAX package's Pallas kernels in interpret mode (128^2, 32-row
  strips, as tests/test_mgfuse.py runs the pair), with different BC
  offsets, subs and dias per system: 1e-12 of max|ref| at every cell.
* The pair solves (solve_relax_pair) against the JAX one.
* The lid step on the bench's route (pair_advect, and rr_in_advect)
  against gerris_tpu at 64^2 for 10 steps (1e-9 relative, as
  tests/test_torch_ns.py), and against the port's per-component route
  (K14 per component, then the same pair solve): 1e-12.
* config_from_jax of the bench's NSConfig.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.ops.pallas import bcg as jbcg  # noqa: E402
from gerris_tpu.ops.pallas import rbgs as jrbgs  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg as tbcg  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs as trbgs  # noqa: E402
from gerris_tpu_torch.solvers import diffusion as tdiff  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (config_from_jax,  # noqa: E402
                                            fieldbc_from_jax,
                                            state_from_numpy)

from test_bench_schedule import cavity_cfg  # noqa: E402
from test_torch_ns import NAMES, RTOL, _configs  # noqa: E402
from test_torch_predict import velocity_bcs  # noqa: E402

TOL = 1e-12
STRIP = 32
LEVEL = 7
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

STEPS = 10


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _check(ref, got, tol=TOL):
    """Every output, nested lists alike, to tol of its max|ref|."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(ref) == len(got)
        for r, g in zip(ref, got):
            _check(r, g, tol)
        return
    ref = np.asarray(ref)
    assert ref.shape == tuple(got.shape)
    err = float(np.max(np.abs(ref - got.numpy())))
    assert err <= tol * float(np.max(np.abs(ref))), err


def _pair_bcs(per_y=False):
    """The lid's U and V BCs (shared signs, U's lid offset 2.0 on the top
    side), or Dirichlet x walls of different values with periodic y."""
    kind = "per_y" if per_y else "lid"
    fbcs = velocity_bcs(kind)
    return fbcs, [fieldbc_from_jax(f) for f in fbcs]


# --- K7 advect2d_pair ---------------------------------------------------------

@pytest.mark.parametrize("kind,rr", [("lid", False), ("lid", True),
                                     ("mixed", False)])
def test_advect2d_pair_matches_pallas(kind, rr):
    """Both components with their own BCs, the gmac correction g, the gp
    and oscale folds; ``rr``: the rr_dia mode's residual pyramid of each
    component's diffusion system."""
    fbcs = velocity_bcs(kind)
    sp = [jbcg.kernel_spec(f, with_face_bc=True) for f in fbcs]
    tfbcs = [fieldbc_from_jax(f) for f in fbcs]
    assert [tbcg.advect_spec(f) for f in tfbcs] == sp
    grid = JGrid(level=LEVEL)
    n = grid.shape[0]
    rng = np.random.default_rng(40)
    v0, v1, g0, g1, gp0, gp1 = (rng.standard_normal((n, n))
                                for _ in range(6))
    ufx, ufy = rng.standard_normal((n + 1, n)), rng.standard_normal((n, n + 1))
    dt = 0.35 * grid.h
    dia = 1.0 / (dt * 1e-3)
    ref = jbcg.advect2d_pair(
        *map(jnp.asarray, (v0, v1, ufx, ufy)), dt, grid.h,
        *map(jnp.asarray, (g0, g1, gp0, gp1)), oscale=-dia,
        rr_dia=dia if rr else None, h2=grid.h ** 2 if rr else None,
        sgns=(sp[0]["sgn"], sp[1]["sgn"]), offs=(sp[0]["off"], sp[1]["off"]),
        per_y=False, fbxs=(sp[0]["fb_x"], None), fbys=(None, sp[1]["fb_y"]),
        S=STRIP, interpret=True)
    T = _t(v0, v1, ufx, ufy, g0, g1, gp0, gp1)
    got = tbcg.advect2d_pair(T[0], T[1], T[2], T[3], dt, TGrid(level=LEVEL),
                             tfbcs, g=T[4:6], gp=T[6:8], oscale=-dia,
                             rr_dia=dia if rr else None)
    if rr:
        assert len(got) == 3 and [len(x) for x in got] == [2, 2, 2]
        assert tuple(got[2][0].shape) == (n // 4, n // 4)
    _check(ref, got)


# --- the diffusion pair: K8a, K8b, K8c ---------------------------------------

def _scal(grid, fbcs, dias, subs):
    """The Pallas pair's per-system rows [dia, sub, off x4] and the port's
    per-system offsets."""
    offss = [jpoisson._signs_offs(grid, f, homogeneous=False)[1]
             for f in fbcs]
    rows = [[d, s] + list(o) for d, s, o in zip(dias, subs, offss)]
    return jnp.asarray(rows, jnp.float64), offss


@pytest.mark.parametrize("per_y", [False, True])
def test_residual_restrict_pair_matches_pallas(per_y):
    """K8a with its own dia, sub and ghost offsets per system (U's lid
    offset 2.0, V's none; or x walls of different values)."""
    fbcs, _ = _pair_bcs(per_y)
    grid = JGrid(level=LEVEL)
    signs, _ = jpoisson._signs_offs(grid, fbcs[0], homogeneous=False)
    dias, subs = [3.7, 2.9], [0.0, 0.1]
    scal, offss = _scal(grid, fbcs, dias, subs)
    assert offss[0] != offss[1]
    rng = np.random.default_rng(41)
    us = [rng.standard_normal(grid.shape) for _ in range(2)]
    rhss = [rng.standard_normal(grid.shape) for _ in range(2)]
    ref = jrbgs.residual_restrict_pair(
        [jnp.asarray(u) for u in us], [jnp.asarray(r) for r in rhss], scal,
        h2=grid.h ** 2, signs=signs, periodic_y=per_y, S=STRIP,
        interpret=True)
    got = trbgs.residual_restrict_pair(_t(*us), _t(*rhss), dias, subs,
                                       h2=grid.h ** 2, signs=signs,
                                       offss=offss, per_y=per_y)
    _check(ref, got)


def test_pair_chain_matches_pallas():
    """K8a -> K8b -> K8c, one cycle of the pair solve, at 128^2 with the
    diffusion's one sweep per level and 12 coarsest sweeps (interpret mode
    traces every sweep); the Pallas K8b's rep layout is un-repped as
    rep[8:8+n_half, ::2]."""
    fbcs, _ = _pair_bcs()
    grid = JGrid(level=LEVEL)
    n_half = grid.shape[0] // 2
    signs, _ = jpoisson._signs_offs(grid, fbcs[0], homogeneous=False)
    dias, subs = [3.7, 2.9], [0.0, 0.1]
    scal, offss = _scal(grid, fbcs, dias, subs)
    h2 = grid.h ** 2
    kw = dict(nsweeps=1, signs=signs)
    ckw = dict(coarsest=12, h2_half=4.0 * h2, per_y=False, min_n=16)
    rng = np.random.default_rng(42)
    us = [rng.standard_normal(grid.shape) for _ in range(2)]
    rhss = [rng.standard_normal(grid.shape) for _ in range(2)]
    Js = [jnp.asarray(u) for u in us]
    jr0, jr1, jr2 = jrbgs.residual_restrict_pair(
        Js, [jnp.asarray(r) for r in rhss], scal, h2=h2, signs=signs,
        periodic_y=False, S=STRIP, interpret=True)
    jdia = jnp.asarray(dias, jnp.float64)
    reps = jrbgs.cascade_prolong_relax_pair(jr1, jr2, jdia, S=STRIP,
                                            interpret=True, **kw, **ckw)
    jout = jrbgs.prolong_relax_pair(reps, jr0, jdia, Js, h2=h2,
                                    periodic_y=False, S=STRIP,
                                    interpret=True, **kw)

    Ts = _t(*us)
    r0, r1, r2 = trbgs.residual_restrict_pair(Ts, _t(*rhss), dias, subs,
                                              h2=h2, signs=signs,
                                              offss=offss)
    _check((jr0, jr1, jr2), (r0, r1, r2))
    du = trbgs.cascade_prolong_relax_pair(r1, r2, dias, **kw, **ckw)
    _check([np.asarray(r)[8:8 + n_half, ::2] for r in reps], du)
    out = trbgs.prolong_relax_pair(du, r0, dias, Ts, h2=h2, **kw)
    _check(jout, out)


def test_solve_relax_pair_matches_jax():
    """The "relax" solver's pair solve (K8a, then K8c from a zero
    correction with max(nrelax, 4) sweeps), with the JAX pair kernels in
    interpret mode, as tests/test_mgfuse.py runs it."""
    fbcs, tfbcs = _pair_bcs()
    grid = JGrid(level=LEVEL)
    dia = 1.0 / (0.8 * grid.h * 1e-3)
    rng = np.random.default_rng(43)
    us = [0.1 * rng.standard_normal(grid.shape) for _ in range(2)]
    rhss = [-(u + 0.01 * grid.h * rng.standard_normal(grid.shape)) * dia
            for u in us]
    jp = jpoisson.MultilevelParams(nrelax=2, solver="relax", ncycles=1)
    saved = jrbgs.residual_restrict_pair, jrbgs.prolong_relax_pair
    jrbgs.residual_restrict_pair = functools.partial(saved[0],
                                                     interpret=True)
    jrbgs.prolong_relax_pair = functools.partial(saved[1], interpret=True)
    try:
        ref, _ = jpoisson.solve_relax_pair(
            [jnp.asarray(u) for u in us], [jnp.asarray(r) for r in rhss],
            grid, fbcs, jp, [dia, dia])
    finally:
        jrbgs.residual_restrict_pair, jrbgs.prolong_relax_pair = saved
    tp = tpoisson.MultilevelParams(nrelax=2, solver="relax", ncycles=1)
    got, stats = tpoisson.solve_relax_pair(_t(*us), _t(*rhss),
                                           TGrid(level=LEVEL), tfbcs, tp,
                                           [dia, dia])
    _check(ref, got)
    assert stats.niter == 1


def test_diffuse_pair_forms_and_fallback():
    """diffuse_pair from extra_rhss builds the rhs that rhss gives; with
    systems that cannot share a launch chain (different ghost signs) it
    solves each component with diffuse()."""
    _, tfbcs = _pair_bcs()
    grid = TGrid(level=6)
    dt, nu = 0.8 * grid.h, 1e-3
    params = tpoisson.MultilevelParams(nrelax=1, coarsest_relax=40,
                                       ncycles=1)
    rng = np.random.default_rng(45)
    vs = _t(*(rng.standard_normal(grid.shape) for _ in range(2)))
    extra = _t(*(0.01 * rng.standard_normal(grid.shape) for _ in range(2)))
    dia = 1.0 / (dt * nu)
    a, _ = tdiff.diffuse_pair(vs, grid, tfbcs, dt, nu, 1.0, params,
                              extra_rhss=extra)
    b, _ = tdiff.diffuse_pair(vs, grid, tfbcs, dt, nu, 1.0, params,
                              rhss=[-(v + e) * dia for v, e in
                                    zip(vs, extra)])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    mixed = [fieldbc_from_jax(f) for f in velocity_bcs("mixed")]
    assert not tpoisson.batched_fixed_eligible(vs, grid, mixed, [dia, dia])
    got, _ = tdiff.diffuse_pair(vs, grid, mixed, dt, nu, 1.0, params,
                                extra_rhss=extra)
    for c in range(2):
        want, _ = tdiff.diffuse(vs[c], grid, mixed[c], dt, nu, beta=1.0,
                                params=params, extra_rhs=extra[c])
        assert torch.equal(got[c], want)


# --- the lid step on the pair routes ------------------------------------------

def _lid_state():
    rng = np.random.default_rng(44)
    return {n: 0.05 * rng.standard_normal((64, 64)) for n in NAMES}


def _jax_lid():
    """The JAX side of lid_runs: STEPS eager steps of the config with the
    bench's pair_advect and rr_in_advect (on the CPU its step takes the
    jnp route, the reference's function for every route of the port)."""
    jcfg, _ = _configs()
    jcfg = dataclasses.replace(jcfg, pair_advect=True, rr_in_advect=True)
    dt = 0.8 * jcfg.grid.h
    js = _lid_state()
    with jax.disable_jit():
        for i in range(STEPS):
            js = jns.ns_step(js, dt, 0.0, jcfg, first_step=i == 0)
    return {n: js[n] for n in ("U", "V", "P")}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"pair_lid": _jax_lid}


@pytest.fixture(scope="module")
def lid_runs():
    """(JAX states, port states by route) after STEPS steps at 64^2 from
    one seeded random state, fixed dt = 0.8 h; the JAX side's pinned by
    tools/jax_pins.py (pair_lid)."""
    _, tcfg = _configs()
    routes = {
        "pair": dataclasses.replace(tcfg, pair_advect=True),
        "rr": dataclasses.replace(tcfg, pair_advect=True, rr_in_advect=True),
        "per_component": tcfg,
    }
    st = _lid_state()
    dt = 0.8 * tcfg.grid.h
    out = {}
    for name, cfg in routes.items():
        ts = state_from_numpy(st, device="cpu")
        for i in range(STEPS):
            ts = tns.ns_step(ts, dt, 0.0, cfg, first_step=i == 0)
        out[name] = ts
    return jax_pins.load("pair_lid"), out


@pytest.mark.parametrize("route", ["pair", "rr"])
def test_ns_step_pair_routes_match_jax(lid_runs, route):
    js, ts = lid_runs
    for n in ("U", "V", "P"):
        a = np.asarray(js[n])
        rel = float(np.max(np.abs(a - ts[route][n].numpy()))
                    / np.max(np.abs(a)))
        assert rel <= RTOL, (n, rel)


def test_pair_route_matches_per_component_route(lid_runs, monkeypatch):
    """K7 (and its rr_dia mode) against two K14 launches before the same
    batched solve: 1e-12 after STEPS steps.  Each route takes the launches
    its configuration names: one advect2d_pair per step (with rr_dia on
    the rr route) or two advect2d, and one batched solve."""
    _, ts = lid_runs
    for route in ("pair", "rr"):
        for n in ("U", "V", "P"):
            ref = ts["per_component"][n]
            rel = float((ts[route][n] - ref).abs().max() / ref.abs().max())
            assert rel <= TOL, (route, n, rel)

    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, kw.get("rr_dia") is not None
                          or kw.get("rr_pre") is not None))
            return fn(*a, **kw)
        return wrapped

    for mod, name in ((tbcg, "advect2d"), (tbcg, "advect2d_pair"),
                      (tpoisson, "solve"), (tpoisson, "solve_fixed_batched")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    _, tcfg = _configs()
    st = state_from_numpy({n: np.zeros(tcfg.grid.shape) for n in NAMES},
                          device="cpu")
    want = {
        "per_component": [("advect2d", False)] * 2
        + [("solve_fixed_batched", False)],
        "pair": [("advect2d_pair", False), ("solve_fixed_batched", False)],
        "rr": [("advect2d_pair", True), ("solve_fixed_batched", True)],
    }
    for route, flags in (("per_component", {}), ("pair", dict(
            pair_advect=True)), ("rr", dict(pair_advect=True,
                                            rr_in_advect=True))):
        calls.clear()
        cfg = dataclasses.replace(tcfg, **flags)
        tns.velocity_advection_diffusion(
            [st["U"], st["V"]], [torch.zeros(cfg.grid.face_shape(0),
                                             dtype=torch.float64),
                                 torch.zeros(cfg.grid.face_shape(1),
                                             dtype=torch.float64)],
            [st["Gx"], st["Gy"]], [st["Gx"], st["Gy"]], cfg.grid, cfg, 0.01)
        assert calls == want[route], (route, calls)


# --- configuration ---------------------------------------------------------------

@pytest.mark.parametrize("rr", [False, True])
def test_config_from_jax_bench_pair(rr):
    """The NSConfig bench.py builds (GERRIS_PAIR_ADVECT=1, and
    GERRIS_RR_ADVECT=0 or 1) carries over with its route flags."""
    bench = dataclasses.replace(cavity_cfg(11), pair_advect=True,
                                rr_in_advect=rr)
    cfg = config_from_jax(bench)
    assert cfg.pair_advect and cfg.rr_in_advect == rr and not cfg.div_in_src
    assert cfg.grid.shape == (2048, 2048)
    assert cfg.diffusion_params == tpoisson.MultilevelParams(
        nrelax=1, omega=1.0, coarsest_relax=40, ncycles=1)
    assert cfg.projection == tpoisson.MultilevelParams(
        nrelax=5, omega=1.5, coarsest_relax=40, ncycles=1)
    assert tns._pair_route(cfg.grid, cfg)
