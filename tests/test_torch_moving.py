"""Moving embedded solids at order 1 (gerris_tpu_torch/models/ns.py with
moving_solid; physics/solid.merge_groups, the merge groups rebuilt every
step on the device in a fixed number of host reads) against the JAX
package on the CPU in float64.

The step: chip_smoke.moving_cfg at level 4 (the impulsively started disk
of tests/test_moving.py, radius 0.15 from x = -0.2 at surface velocity
(0.5, 0), with nu 1e-3 so that the moving Dirichlet surface's viscous
solve runs), from a seeded velocity, dt 0.25 h: the initial projection
and two ns_steps on the port and on the JAX package (eagerly,
jax.disable_jit: the only JAX step of this file), U, V, P, Pmac, Gx and
Gy within 1e-10 of max after each.  The disk's small cells all merge
into a neighbour that is not small, so the port's transitive merge and
the reference's two hops agree.  The Galilean gate runs on the port at
level 6, here and on the card (chip_smoke.moving_gate)."""
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
from gerris_tpu.physics import solid as jsolid  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.core.metric import MetricStretch  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.physics import solid  # noqa: E402
from gerris_tpu_torch.solvers.poisson import MultilevelParams  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import metric_reference  # noqa: E402

import jax_pins  # noqa: E402

RTOL = 1e-10
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
CPU = torch.device("cpu")


def _jphi(x, y, t):
    return jnp.sqrt((x + 0.2 - 0.5 * t) ** 2 + y ** 2) - chip_smoke.MOVING_R


def moving_jcfg(level, order, **kw):
    """The JAX NSConfig of chip_smoke.moving_cfg."""
    args = dict(grid=JGrid(level), u_bcs=(jbc.velocity_bc(0, 2),
                                          jbc.velocity_bc(1, 2)),
                nu=chip_smoke.MOVING_NU, solid_phi=_jphi, moving_solid=True,
                moving_order=order, surface_u=(chip_smoke.MOVING_U, 0.0))
    args.update(kw)
    return jns.NSConfig(**args)


def _rel(ref, got):
    """max|ref - got| / max|ref|, or max|got| where ref is 0 (ref a JAX
    array, got a CPU tensor)."""
    ref = np.asarray(ref)
    scale = np.max(np.abs(ref))
    return float(np.max(np.abs(ref - got.numpy())) / (scale if scale > 0
                                                      else 1.0))


def _moving_state(grid):
    x, y = (np.asarray(c) for c in JGrid(4).centers)
    st = {n: np.zeros(grid.shape) for n in NAMES}
    st["U"], st["V"] = metric_reference.initial_state(x, y)
    return st


def _jax_moving(order):
    """The JAX side of compare_moving_step: the initial projection and two
    eager steps."""
    jcfg = moving_jcfg(4, order)
    dt = chip_smoke.MOVING_DT * jcfg.grid.h
    js = {k: jnp.asarray(v) for k, v in _moving_state(jcfg.grid).items()}
    with jax.disable_jit():
        jout = [jns.initial_projection(js, dt, 0.0, jcfg)]
        for i in range(2):
            jout.append(jns.ns_step(jout[-1], dt, i * dt, jcfg,
                                    first_step=(i == 0), cstart=0))
    return {f"{k}_{n}": st[n] for k, st in enumerate(jout) for n in NAMES}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {f"moving_{order}": functools.partial(_jax_moving, order)
            for order in (1, 2)}


def compare_moving_step(order):
    """The initial projection and two ns_steps of the disk at level 4 and
    ``order`` from metric_reference.initial_state's velocity, on the port
    and on the JAX package (eagerly, pinned by tools/jax_pins.py:
    moving_1, moving_2): every field within RTOL of max after each; the
    solid's cells at rest; no kernel launched on the CPU."""
    ref = jax_pins.load(f"moving_{order}")
    tcfg = chip_smoke.moving_cfg(4, order)
    grid = tcfg.grid
    dt = chip_smoke.MOVING_DT * grid.h
    rbgs.reset_launch_counts()
    tout = [tns.initial_projection(
        convert.state_from_numpy(_moving_state(grid), device="cpu"), dt,
        0.0, tcfg)]
    for i in range(2):
        tout.append(tns.ns_step(tout[-1], dt, i * dt, tcfg,
                                first_step=(i == 0), cstart=0))
    errs = {(k, n): _rel(ref[f"{k}_{n}"], got[n])
            for k, got in enumerate(tout) for n in NAMES}
    assert max(errs.values()) <= RTOL, errs
    t1 = tout[-1]
    a = solid.solid_fractions(
        tcfg.grid, lambda x, y: tcfg.solid_phi(x, y, 2 * dt), CPU)[0]
    assert bool((t1["U"][a == 0] == 0).all() and (t1["V"][a == 0] == 0).all())
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def test_moving_step_matches_jax():
    compare_moving_step(1)


def test_moving_cfg_is_the_tests_disk():
    """chip_smoke.moving_cfg is the JAX configuration above carried over
    with its level set's torch counterpart (up to the schedule:
    config_from_jax gives the TPU's raised nrelax); Re = U D / nu = 150."""
    ours = chip_smoke.moving_cfg(4, 2)
    conv = convert.config_from_jax(moving_jcfg(4, 2),
                                   solid_phi=chip_smoke.moving_phi)
    for f in ("grid", "u_bcs", "p_bc", "nu", "beta", "advection",
              "solid_phi", "surface_u", "moving_solid", "moving_order",
              "axi", "metric"):
        assert getattr(ours, f) == getattr(conv, f), f
    assert chip_smoke.MOVING_U * 2 * chip_smoke.MOVING_R / ours.nu == \
        pytest.approx(150.0)


def test_static_equivalence():
    """tests/test_moving.py::test_static_equivalence on the port: a
    time-independent level set through the moving path (fractions re-cut,
    merge table, divergence sources) gives the static path's step (merge
    groups built once) to 1e-10."""
    grid = Grid(level=5)
    proj = MultilevelParams(tolerance=1e-9, nitermax=50)
    base = dict(grid=grid, u_bcs=chip_smoke.walls(), projection=proj,
                approx_projection=proj)
    r = chip_smoke.MOVING_R
    cfg_s = tns.NSConfig(solid_phi=lambda x, y: torch.sqrt(x ** 2 + y ** 2)
                         - r, **base)
    cfg_m = tns.NSConfig(solid_phi=lambda x, y, t: torch.sqrt(x ** 2 + y ** 2)
                         - r, moving_solid=True, surface_u=(0.0, 0.0),
                         **base)
    x, y = tns.cell_centers(grid, CPU, torch.float64)
    z = torch.zeros(grid.shape, dtype=torch.float64)
    s0 = {"U": torch.where(torch.sqrt(x ** 2 + y ** 2) > r + 0.05,
                           0.1 * torch.sin(2 * np.pi * y), 0.0),
          "V": z, "P": z, "Pmac": z, "Gx": z, "Gy": z}
    dt = 0.2 * grid.h
    a = tns.ns_step(dict(s0), dt, 0.0, cfg_s)
    b = tns.ns_step(dict(s0), dt, 0.0, cfg_m)
    for k in ("U", "V", "P"):
        assert float((a[k] - b[k]).abs().max()) < 1e-10, k


def test_impulsive_drag():
    """tests/test_moving.py::test_impulsive_drag on the port: six steps of
    the inviscid disk at level 6; the fluid ahead of it moves forward."""
    grid = Grid(level=6)
    proj = MultilevelParams(tolerance=1e-9, nitermax=50)
    cfg = tns.NSConfig(grid=grid, u_bcs=chip_smoke.walls(),
                       solid_phi=chip_smoke.moving_phi, moving_solid=True,
                       surface_u=(0.5, 0.0), projection=proj,
                       approx_projection=proj)
    z = torch.zeros(grid.shape, dtype=torch.float64)
    s = {k: z for k in NAMES}
    dt, t = 0.25 * grid.h, 0.0
    for i in range(6):
        s = tns.ns_step(s, dt, t, cfg, first_step=(i == 0))
        t += dt
    U = s["U"].numpy()
    assert np.isfinite(U).all() and bool(torch.isfinite(s["P"]).all())
    x, y = (c.numpy() for c in tns.cell_centers(grid, CPU, torch.float64))
    ahead = (np.abs(y) < 0.05) & (x > -0.2 + 0.5 * t + 0.15) \
        & (x < -0.2 + 0.5 * t + 0.25)
    assert U[ahead].mean() > 0.02


def test_galilean_far_field():
    """tests/test_moving.py::test_galilean_uniform_flow on the port at its
    level 6 (the card's gate too): the disk moving with a uniform stream
    leaves the far field within 0.06 of it, every fluid cell within
    0.6."""
    far_u, far_v, all_u, all_v = chip_smoke.galilean(CPU)
    assert max(far_u, far_v) < chip_smoke.GALILEAN_FAR
    assert max(all_u, all_v) < 0.6


def _row_system(avals):
    """tests/test_torch_solid.py's row: the middle row holds ``avals``,
    the x faces between consecutive fluid cells open."""
    n = len(avals)
    a = np.zeros((n, 3))
    a[:, 1] = avals
    sx = np.zeros((n + 1, 3))
    for i in range(n - 1):
        if avals[i] > 0 and avals[i + 1] > 0:
            sx[i + 1, 1] = 1.0
    sy = torch.zeros(n, 4, dtype=torch.float64)
    return torch.tensor(a), (torch.tensor(sx), sy)


def _lattice():
    """A 24 x 24 block of small cells (a in {0.1, 0.2, 0.3}, one in 20
    full), a fifth of its x faces closed: mutual pairs, cycles and
    groups of up to ~20 cells."""
    rng = np.random.default_rng(0)
    n = 24
    a = torch.from_numpy(rng.integers(1, 4, (n, n)) * 0.1)
    a[torch.from_numpy(rng.random((n, n)) < 0.05)] = 1.0
    sx = torch.ones(n + 1, n, dtype=torch.float64)
    sy = torch.ones(n, n + 1, dtype=torch.float64)
    sx[0], sx[-1], sy[:, 0], sy[:, -1] = 0.0, 0.0, 0.0, 0.0
    sx[torch.from_numpy(rng.random((n + 1, n)) < 0.2)] = 0.0
    return a, (sx, sy)


def _merge_case(case):
    if case == "cylinder":
        g = Grid(7, extents=(3, 1))
        return solid.solid_fractions(g, chip_smoke.cylinder_phi, CPU)
    if case == "lattice":
        return _lattice()
    chain60 = list(np.linspace(0.01, 0.4, 59)) + [1.0]
    return _row_system({"mutual": [0.0, 0.2, 0.3, 0.0],
                        "chain6": [0.04, 0.08, 0.12, 0.16, 0.2, 0.24, 1.0,
                                   1.0],
                        "chain3": [0.0, 0.12, 0.2, 0.24, 1.0, 1.0],
                        "chain60": chain60}[case])


def _components(a, s):
    """The groups of the links small cell - target (_merge_targets), by a
    plain union-find on the host: sorted lists of flat indices, in
    increasing least index."""
    small, tgt = (t.reshape(-1).tolist() for t in solid._merge_targets(a, s))
    parent = {}

    def root(i):
        while parent.setdefault(i, i) != i:
            i = parent[i]
        return i
    for i, sm in enumerate(small):
        if sm:
            ri, rj = root(i), root(tgt[i])
            parent[max(ri, rj)] = min(ri, rj)
    groups = {}
    for i in parent:
        groups.setdefault(root(i), []).append(i)
    return sorted(sorted(g) for g in groups.values())


@pytest.mark.parametrize("case", ["cylinder", "mutual", "chain6", "chain3",
                                  "chain60", "lattice"])
def test_merge_groups_read_twice_whatever_the_chains(case):
    """merge_groups' groups are the connected components of the links
    (a union-find on the host: the transitive groups pinned in
    tests/test_torch_solid.py, a mutual pair, chains of 6 and 59 small
    cells, the cylinder's geometry at level 7, a lattice of mutual pairs
    and cycles), rows in increasing least index, members in increasing
    index; they take two host reads whatever their sizes
    (chip_smoke.count_syncs on the CPU counts the calls that would sync
    the card); and merged_cell_update sums each group left to right, the
    bits of a plain loop."""
    a, s = _merge_case(case)
    reads, groups = chip_smoke.count_syncs(lambda: solid.merge_groups(a, s),
                                           CPU)
    assert reads == 2
    want = _components(a, s)
    members = groups.members.tolist()
    rows = [[members[k] for k in row if k < len(members)]
            for row in groups.index.tolist()]
    assert rows == want
    assert groups.index.shape[1] == max(len(g) for g in want)
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.standard_normal(a.shape))
    fv = torch.from_numpy(rng.standard_normal(a.shape))
    got = solid.merged_cell_update(v, fv, a, s, groups).reshape(-1)
    num = (a * v + fv).reshape(-1).tolist()
    af = a.reshape(-1).tolist()
    for g in want:
        tn = ta = 0.0
        for i in g:
            tn, ta = tn + num[i], ta + af[i]
        assert all(float(got[i]) == tn / ta for i in g)


def test_merge_groups_of_no_cut_cell_read_twice():
    """No small cell: no group, and the same two host reads."""
    a = torch.ones(8, 8, dtype=torch.float64)
    s = (torch.ones(9, 8, dtype=torch.float64),
         torch.ones(8, 9, dtype=torch.float64))
    reads, groups = chip_smoke.count_syncs(lambda: solid.merge_groups(a, s),
                                           CPU)
    assert reads == 2 and groups.ngroups == 0


def test_solid_entering_the_box():
    """A disk that starts outside the box and enters it through the x-low
    wall: its cut cells and merge groups grow from none, every step
    finite, and each step's host reads stay its solves' plus
    chip_smoke.MOVING_SYNCS."""
    def phi(x, y, t):
        return torch.sqrt((x + 0.66 - 2.0 * t) ** 2 + y ** 2) - 0.15

    cfg = tns.NSConfig(grid=Grid(5), u_bcs=chip_smoke.walls(),
                       nu=chip_smoke.MOVING_NU, solid_phi=phi,
                       moving_solid=True, surface_u=(2.0, 0.0))
    z = torch.zeros(cfg.grid.shape, dtype=torch.float64)
    st = {k: z for k in NAMES}
    dt, t, ngroups = 0.125 * cfg.grid.h, 0.0, []
    for i in range(10):
        ngroups.append(tns._moving_weights(cfg, [st["U"], st["V"]], dt,
                                           t)[0].groups.ngroups)
        with chip_smoke.recording_solves() as log:
            n, st = chip_smoke.count_syncs(lambda: tns.ns_step(
                st, dt, t, cfg, first_step=(i == 0)), CPU)
        assert n == sum(x[3] for x in log) + chip_smoke.MOVING_SYNCS
        assert all(bool(torch.isfinite(v).all()) for v in st.values())
        t += dt
    assert ngroups[:3] == [0, 0, 0] and min(ngroups[4:]) > 0


def test_moving_step_host_reads_are_a_constant():
    """One moving step reads back what its solves read (their adaptive
    loops' conditions) and three more: the Dirichlet surface's cut cells
    and the merge groups' two (chip_smoke.MOVING_SYNCS)."""
    cfg = chip_smoke.moving_cfg(5, 1)
    s = chip_smoke.moving_sim(CPU, 1, level=5, dtype=torch.float64)
    s.run(max_steps=1)
    with chip_smoke.recording_solves() as log:
        n, _ = chip_smoke.count_syncs(lambda: tns.ns_step(
            s.state, s.dt, s.time.t, cfg), CPU)
    assert n == sum(x[3] for x in log) + chip_smoke.MOVING_SYNCS


def test_redistribute_small_matches_jax_and_its_wrap():
    """_redistribute_small against the reference's on the disk's geometry
    at level 5 (to the last bit), and the reference's periodic roll,
    copied (ROADMAP Queue 3): a small cell on the x-low side whose
    largest face is the box's sends its source to the cell across the
    box."""
    g = Grid(5)
    a, s = solid.solid_fractions(g, lambda x, y: chip_smoke.moving_phi(
        x, y, 0.1), CPU)
    src = torch.from_numpy(np.random.default_rng(3).standard_normal(g.shape))
    ref = jns._redistribute_small(jnp.asarray(src.numpy()),
                                  jnp.asarray(a.numpy()),
                                  tuple(jnp.asarray(f.numpy()) for f in s))
    got = tns._redistribute_small(src, a, s)
    assert np.array_equal(np.asarray(ref), got.numpy())
    n = 8
    a = torch.ones(n, n, dtype=torch.float64)
    a[0, 3] = 0.3
    sx, sy = torch.ones(n + 1, n, dtype=torch.float64), \
        torch.ones(n, n + 1, dtype=torch.float64)
    sx[1, 3], sy[0, 3], sy[0, 4] = 0.2, 0.1, 0.1
    src = torch.zeros(n, n, dtype=torch.float64)
    src[0, 3] = 1.0
    got = tns._redistribute_small(src, a, (sx, sy))
    ref = np.asarray(jns._redistribute_small(
        jnp.asarray(src.numpy()), jnp.asarray(a.numpy()),
        (jnp.asarray(sx.numpy()), jnp.asarray(sy.numpy()))))
    assert float(got[n - 1, 3]) == 1.0 == ref[n - 1, 3]
    assert float(got.abs().sum()) == 1.0


def test_viscous_callable_surface_velocity_is_refused():
    """The reference's viscous solve calls a surface velocity f(x, y) at
    the surface points (gerris_tpu/physics/solid.py:233-236), so a
    function of (x, y, t) fails there (a TypeError); the port refuses it
    with NotImplementedError naming the reason, and takes a function of
    (x, y) as the reference does."""
    def us_t(x, y, t):
        return 0.5 + 0.0 * x

    def us_xy(x, y):
        return 0.5 + 0.0 * x

    ds = jsolid.DirichletSurface(JGrid(4), lambda x, y: _jphi(x, y, 0.0))
    with pytest.raises(TypeError):
        ds.surface_value(us_t)
    cfg = dataclasses.replace(chip_smoke.moving_cfg(4, 1),
                              surface_u=(us_t, 0.0))
    z = torch.zeros(cfg.grid.shape, dtype=torch.float64)
    st = {k: z for k in NAMES}
    dt = 0.25 * cfg.grid.h
    with pytest.raises(NotImplementedError, match="f\\(x, y\\)"):
        tns.ns_step(st, dt, 0.0, cfg, first_step=True)
    out = tns.ns_step(st, dt, 0.0, dataclasses.replace(
        cfg, surface_u=(us_xy, 0.0)), first_step=True)
    assert bool(torch.isfinite(out["U"]).all())
    inviscid = dataclasses.replace(cfg, nu=0.0)
    assert bool(torch.isfinite(tns.ns_step(st, dt, 0.0, inviscid,
                                           first_step=True)["U"]).all())


@pytest.mark.parametrize("kw,err,match", [
    (dict(axi=True), NotImplementedError, "axisymmetric"),
    (dict(metric=MetricStretch(1.0, 0.1)), NotImplementedError, "metric"),
    (dict(solid_phi=None), ValueError, "solid_phi"),
])
def test_moving_solid_refuses_what_the_reference_does_not_compose(kw, err,
                                                                   match):
    """A moving solid with the axisymmetric metric raises where the
    reference asserts (ns.py:897); with a general metric, which the
    reference's moving step drops, it raises too; without a level set it
    raises."""
    base = dict(grid=Grid(4), u_bcs=chip_smoke.walls(),
                solid_phi=chip_smoke.moving_phi, moving_solid=True)
    base.update(kw)
    with pytest.raises(err, match=match):
        tns.NSConfig(**base)
