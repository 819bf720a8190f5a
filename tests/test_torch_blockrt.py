"""The block engines (gerris_tpu_torch/solvers/blockmg.py, blockrt.py)
against the JAX package's on the CPU in float64: the block tables of a
graded ring mesh bit for bit (static and capacity-padded, the capacities
kept across a re-mesh), BlockSolver's cycle, the runtime-table solve
against BlockSolver, and the runtime-table solve through amr.solve_block with unit coefficients, per-face alpha, a scalar
and a cell dia, Dirichlet and Neumann sides, to 1e-11 of max."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.solvers import amr as jamr  # noqa: E402
from gerris_tpu.solvers import blockmg as jmg  # noqa: E402
from gerris_tpu.solvers import blockrt as jrt  # noqa: E402
from gerris_tpu.solvers import composite as jcomp  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.solvers import amr  # noqa: E402
from gerris_tpu_torch.solvers import blockmg  # noqa: E402
from gerris_tpu_torch.solvers import blockrt  # noqa: E402
from gerris_tpu_torch.solvers import composite as comp  # noqa: E402
from gerris_tpu_torch.solvers import poisson  # noqa: E402

LMIN, LMAX = 4, 6
TOL = 1e-11


def ring_depth(r=0.3, w=4):
    gf = JGrid(level=LMAX)
    x, y = (np.asarray(c) for c in gf.centers)
    d = np.abs(np.sqrt(x * x + y * y) - r)
    return jcomp.grade_depth_map(
        np.where(d < w * gf.h, LMAX, LMIN).astype(np.int32))


def test_bucket_equals_the_reference():
    for n in list(range(0, 200)) + [1000, 4096, 12345]:
        assert blockrt.bucket(n) == jrt.bucket(n)
        assert blockrt.bucket(n) >= n


def test_block_tables_equal_the_reference():
    """BlockMesh's per-level tables, then build_tables' padded ones; a
    second, smaller mesh built with the first one's capacities keeps
    them, as the reference's does."""
    D = ring_depth()
    mesh = blockmg.BlockMesh.build(Grid(LMIN), LMAX, D, B=8)
    jmesh = jmg.BlockMesh.build(JGrid(LMIN), LMAX, D, B=8)
    for l in jmesh.lv:
        assert set(mesh.lv[l]) == set(jmesh.lv[l])
        for k, v in jmesh.lv[l].items():
            assert np.array_equal(mesh.lv[l][k], v), (l, k)
    assert mesh.n_active() == jmesh.n_active()
    assert mesh.n_leaf_cells() == jmesh.n_leaf_cells()
    caps = None
    for r in (0.3, 0.2):
        D = ring_depth(r)
        rt, tables, _ = blockrt.make_blockrt(Grid(LMIN), LMAX, D, B=8,
                                             caps=caps, device="cpu")
        jr, jtables, _ = jrt.make_blockrt(JGrid(LMIN), LMAX, D, B=8,
                                          caps=caps)
        assert rt.caps == jr.caps
        caps = rt.caps_dict
        for l, t in jtables.items():
            # beside the reference's tables: the count and the derived
            # index helpers (blockmg.with_helpers)
            assert {k for k in tables[l] if not k.startswith("_")} \
                == set(t) | {"n"}
            for k, v in t.items():
                assert np.array_equal(tables[l][k].numpy(), np.asarray(v)), \
                    (r, l, k)
            # the padding stays under ~25% (8-aligned, at least 8)
            assert tables[l]["n"] <= rt.caps_dict[l] \
                <= max(8, 1.25 * tables[l]["n"] + 8)


def test_block_solver_cycle_equals_the_reference():
    D = ring_depth()
    mesh = blockmg.BlockMesh.build(Grid(LMIN), LMAX, D, B=8)
    jmesh = jmg.BlockMesh.build(JGrid(LMIN), LMAX, D, B=8)
    fbc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    jfbc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    p = poisson.MultilevelParams(nrelax=2)
    jp = jpoisson.MultilevelParams(nrelax=2)

    def fn(x, y):
        return np.cos(3 * x) * np.sin(2 * y + 0.3)
    solver = blockmg.BlockSolver(mesh, fbc, p, device="cpu")
    jsolver = jmg.BlockSolver(jmesh, jfbc, jp)
    rhs, jrhs = mesh.field_from_fn(fn, device="cpu"), \
        jmesh.field_from_fn(fn)
    u, hist = solver.solve(rhs, max_cycles=2)
    ju, jhist = jsolver.solve(jrhs, max_cycles=2)
    np.testing.assert_allclose(hist, jhist, rtol=1e-10)
    for l in ju:
        want = np.asarray(ju[l])
        assert float(np.abs(u[l].numpy() - want).max()) \
            < TOL * np.abs(want).max()
    dense = mesh.to_dense(u, LMAX)
    assert dense.shape == (1 << LMAX,) * 2


def test_blockrt_solve_equals_the_block_solver():
    """The runtime-table solve, as the AMR step runs it, against the
    static-table BlockSolver on the same mesh (the JAX package's
    test_blockrt_matches_blockmg on the port alone): four cycles, unit
    coefficients, homogeneous Dirichlet, every level's leaves to 1e-11
    of max."""
    D = ring_depth()
    fbc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    p = poisson.MultilevelParams(nrelax=4)
    mesh = blockmg.BlockMesh.build(Grid(LMIN), LMAX, D, B=8)
    solver = blockmg.BlockSolver(mesh, fbc, p, device="cpu")
    rhs = mesh.field_from_fn(lambda x, y: np.cos(3 * x) * np.sin(2 * y + 0.3),
                             device="cpu")
    want = {l: torch.zeros_like(rhs[l]) for l in rhs}
    for _ in range(4):
        want = solver.cycle(want, rhs)
    rt, tables, _ = blockrt.make_blockrt(Grid(LMIN), LMAX, D, B=8,
                                         device="cpu")
    rhs_p = {l: torch.zeros((rt.caps_dict[l], 8, 8), dtype=rhs[l].dtype)
             for l in rhs}
    for l in rhs:
        rhs_p[l][:rhs[l].shape[0]] = rhs[l]
    got = blockrt.solve(rhs_p, tables, rt, fbc, p, dia=0.0, ncycles=4)
    scale = max(float(want[l].abs().max()) for l in want)
    for l in rhs:
        leaf = torch.as_tensor(mesh.lv[l]["leaf"])
        if leaf.any():
            d = (got[l][:rhs[l].shape[0]] - want[l])[leaf].abs().max()
            assert float(d) < TOL * scale, (l, float(d))


def _inputs(cg, seed):
    rng = np.random.default_rng(seed)
    lv = range(cg.lmin, cg.lmax + 1)
    return ({l: rng.standard_normal(cg.grid(l).shape) for l in lv},
            {l: rng.standard_normal(cg.grid(l).shape) for l in lv},
            {l: tuple(1.0 + rng.random(cg.grid(l).face_shape(a))
                      for a in range(2)) for l in lv},
            {l: 10.0 + rng.random(cg.grid(l).shape) for l in lv})


@pytest.mark.parametrize("coef,side", [
    ("unit", "lid"), ("cell_dia", "lid"), ("alpha", "neumann")])
def test_solve_block_equals_the_reference(coef, side):
    """amr.solve_block to tolerance (then synced to dense levels) with
    the reference's block engine, same cycle count, same residual: unit
    coefficients and a cell dia on the lid's sides, face coefficients on
    pure Neumann sides (the rhs's leaf mean removed).  The scalar dia and
    the other pairings run in tests/test_torch_amr_ns.py's pinned steps
    (lid_block, drop_block, osc_block)."""
    D = ring_depth()
    cg = comp.CompositeGrid.from_depth_map(Grid(LMIN), LMAX, D, graded=True)
    jcg = jcomp.CompositeGrid.from_depth_map(JGrid(LMIN), LMAX, D,
                                             graded=True)
    rt, tables, _ = blockrt.make_blockrt(Grid(LMIN), LMAX, D, B=8,
                                         device="cpu")
    jr, jtables, _ = jrt.make_blockrt(JGrid(LMIN), LMAX, D, B=8)
    if side == "lid":
        fbc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                              top=bc.Dirichlet(1.0))
        jfbc = jbc.FieldBC.make(2, default=jbc.Dirichlet(0.0),
                                top=jbc.Dirichlet(1.0))
    else:
        fbc, jfbc = bc.default_scalar_bc(2), jbc.default_scalar_bc(2)
    rhs, u0, alpha, dcell = _inputs(cg, 11)
    kw = {"unit": {}, "alpha": {"alpha": alpha},
          "scalar_dia": {"dia": {l: 7.5 for l in rhs}},
          "cell_dia": {"dia": dcell}}[coef]

    def conv(d, f):
        return {k: {l: (tuple(f(a) for a in v) if isinstance(v, tuple)
                        else (f(v) if isinstance(v, np.ndarray) else v))
                    for l, v in m.items()} for k, m in d.items()}
    jkw = conv(kw, jnp.asarray)
    tkw = conv(kw, torch.tensor)
    p = poisson.MultilevelParams(nrelax=2, minlevel=2, tolerance=1e-5,
                                 nitermax=6)
    jp = jpoisson.MultilevelParams(nrelax=2, minlevel=2, tolerance=1e-5,
                                   nitermax=6)
    ju, jn, jrinf = jax.jit(lambda r, u, k: jamr.solve_block(
        r, jcg.topo, jcg.leaf_arrays(), jfbc, jp, jr, jtables, u0=u,
        **k))({l: jnp.asarray(v) for l, v in rhs.items()},
              {l: jnp.asarray(v) for l, v in u0.items()}, jkw)
    u, stats = amr.solve_block({l: torch.tensor(v) for l, v in rhs.items()},
                               cg.topo, cg.leaf_arrays("cpu"), fbc, p, rt,
                               tables,
                               u0={l: torch.tensor(v) for l, v in u0.items()},
                               **tkw)
    assert stats.niter == int(jn)
    scale = max(float(np.abs(v).max()) for v in rhs.values())
    assert abs(float(stats.rinf) - float(jrinf)) < TOL * scale
    for l in ju:
        want = np.asarray(ju[l])
        assert float(np.abs(u[l].numpy() - want).max()) \
            < TOL * np.abs(want).max(), l


def _sourceless(mesh):
    """Ghost strips that find neither a same-level nor a parent-level
    neighbour inside the box."""
    return sum(int(((d["nbr"] < 0) & (d["pnbr"] < 0) & ~d["bnd"]).sum())
               for l, d in mesh.lv.items() if l > mesh.lmin)


def test_block_mesh_grades_the_leaves():
    """From 5 levels on, the reference's block map leaves adjacent leaf
    blocks more than one level apart (a leaf takes its deepest finest
    block's depth): some ghosts have no source and its block solve
    diverges (ROADMAP Queue 3).  The port deepens the map until adjacent
    leaves differ by one level at most; its solve then converges, near
    the dense engine's solution."""
    lmin, lmax = 3, 7
    gf = JGrid(level=lmax)
    x, y = (np.asarray(c) + 0.5 for c in gf.centers)
    D = jcomp.grade_depth_map(np.where(
        np.abs(np.sqrt(x * x + y * y) - 0.1) < 5 * gf.h, lmax,
        lmin).astype(np.int32))
    assert _sourceless(jmg.BlockMesh.build(JGrid(lmin), lmax, D)) > 0
    mesh = blockmg.BlockMesh.build(Grid(lmin), lmax, D)
    assert _sourceless(mesh) == 0
    nfb = (1 << lmax) // 8
    L = np.zeros((nfb, nfb), int)
    for l, d in mesh.lv.items():
        rep = 1 << (lmax - l)
        for bx, by in zip(d["bx"][d["leaf"]], d["by"][d["leaf"]]):
            L[bx * rep:(bx + 1) * rep, by * rep:(by + 1) * rep] = l
    assert np.abs(np.diff(L, axis=0)).max() <= 1
    assert np.abs(np.diff(L, axis=1)).max() <= 1
    rt, tables, _ = blockrt.make_blockrt(Grid(lmin), lmax, D, device="cpu")
    cg = comp.CompositeGrid.from_depth_map(Grid(lmin), lmax, D, graded=True)
    # a smooth rhs (pure Neumann, mean free): the two engines' fine-coarse
    # stencils differ, so their solutions agree to discretization error
    rhs = {l: torch.tensor(np.cos(2 * np.pi * cg.grid(l).centers[0])
                           * np.cos(2 * np.pi * cg.grid(l).centers[1]))
           for l in range(lmin, lmax + 1)}
    fbc = bc.default_scalar_bc(2)
    p = poisson.MultilevelParams(tolerance=1e-6, nitermax=40)
    leaf = cg.leaf_arrays("cpu")
    u, stats = amr.solve_block(rhs, cg.topo, leaf, fbc, p, rt, tables)
    scale = max(float(v.abs().max()) for v in rhs.values())
    assert stats.niter < p.nitermax and float(stats.rinf) < 1e-6 * scale
    ud, _ = amr.solve(rhs, cg.topo, leaf, fbc, p)
    exact = -rhs[lmax] / (8 * np.pi ** 2)

    def err(v):
        e = v[lmax] - exact
        return float((e - e.mean()).abs().max())
    # both discretize the same problem (their fine-coarse stencils
    # differ): the block solution's error is of the dense one's size
    # (mostly the base level's, h = 1/8)
    assert err(u) < 2.0 * err(ud) < 0.5 * float(exact.abs().max())
