"""The dense-mask composite engine (gerris_tpu_torch/solvers/amr.py)
against the JAX package's on the CPU in float64, seeded numpy inputs on
static meshes (2D ring, the capillary wave's 1 x 3 box, a 3D sphere):
sync with constant, callable and homogeneous BCs, fill_slaves, sync_vof,
sync_faces, the leaf residual with face coefficients and a cell dia, one
cycle and the tolerance solve, to 1e-11 of max."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.solvers import amr as jamr  # noqa: E402
from gerris_tpu.solvers import composite as jcomp  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.solvers import amr  # noqa: E402
from gerris_tpu_torch.solvers import composite as comp  # noqa: E402
from gerris_tpu_torch.solvers import poisson  # noqa: E402

TOL = 1e-11


def _lid(mod):
    return mod.FieldBC.make(2, default=mod.Dirichlet(0.0),
                            top=mod.Dirichlet(1.0))


def _box(mod):
    per = (mod.Periodic(), mod.Periodic())
    return mod.FieldBC((per, (mod.Neumann(0.5), mod.Dirichlet(-1.0))))


def _wave(mod, lib):
    """A callable Dirichlet value on the top side."""
    return mod.FieldBC.make(2, default=mod.Neumann(0.0),
                            top=mod.Dirichlet(lambda x, y, t=0.0:
                                              lib.sin(3.0 * x) + t))


CASES = {
    "lid": (dict(level=3, dim=2), 5, _lid, _lid),
    "box": (dict(level=3, dim=2, origin=(-0.5, -1.5), extents=(1, 3)), 5,
            _box, _box),
    "callable": (dict(level=3, dim=2), 5, lambda m: _wave(m, jnp),
                 lambda m: _wave(m, torch)),
    "sphere3d": (dict(level=2, dim=3), 4,
                 lambda m: m.FieldBC.make(3, default=m.Dirichlet(0.0),
                                          top=m.Dirichlet(1.0)),
                 lambda m: m.FieldBC.make(3, default=m.Dirichlet(0.0),
                                          top=m.Dirichlet(1.0))),
}


def _setup(name):
    kw, lmax, jf, tf = CASES[name]
    dim = kw["dim"]
    if dim == 2:
        def fn(x, y, l):
            return np.abs(np.sqrt(x * x + (y % 1.0 - 0.5) ** 2) - 0.25) \
                < 2.0 / (1 << l)
    else:
        def fn(x, y, z, l):
            return x * x + y * y + z * z < 0.3 ** 2
    jcg = jcomp.CompositeGrid.from_refine_fn(JGrid(**kw), lmax, fn)
    cg = comp.CompositeGrid.from_refine_fn(Grid(**kw), lmax, fn)
    return jcg, cg, jf(jbc), tf(bc)


def _fields(cg, seed, faces=False):
    rng = np.random.default_rng(seed)
    levels = range(cg.lmin, cg.lmax + 1)
    if faces:
        return {l: [rng.standard_normal(cg.grid(l).face_shape(a))
                    for a in range(cg.base.dim)] for l in levels}
    return {l: rng.standard_normal(cg.grid(l).shape) for l in levels}


def _j(d):
    return {l: (type(v)(jnp.asarray(a) for a in v)
                if isinstance(v, (list, tuple)) else jnp.asarray(v))
            for l, v in d.items()}


def _t(d):
    return {l: (type(v)(torch.tensor(a) for a in v)
                if isinstance(v, (list, tuple)) else torch.tensor(v))
            for l, v in d.items()}


def _err(want, got):
    """max over levels (and faces) of |got - want| / max|want|."""
    out = 0.0
    for l in want:
        ws = want[l] if isinstance(want[l], (list, tuple)) else [want[l]]
        gs = got[l] if isinstance(got[l], (list, tuple)) else [got[l]]
        for w, g in zip(ws, gs):
            w = np.asarray(w)
            out = max(out, float(np.abs(g.numpy() - w).max())
                      / max(float(np.abs(w).max()), 1e-300))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_syncs_equal_the_reference(name):
    """sync (the BCs' values, and homogeneous), fill_slaves and sync_vof
    of seeded fields, sync_faces of seeded faces."""
    jcg, cg, jfbc, tfbc = _setup(name)
    topo, jtopo = cg.topo, jcg.topo
    leaf, jleaf = cg.leaf_arrays("cpu"), jcg.leaf_arrays()
    u = _fields(cg, 1)
    f = {l: np.clip(v, -0.3, 1.3) for l, v in u.items()}
    uf = _fields(cg, 2, faces=True)
    sbc, jsbc = bc.default_scalar_bc(cg.base.dim), \
        jbc.default_scalar_bc(cg.base.dim)

    def reference(u, f, uf):
        return (jamr.sync(u, jtopo, jleaf, jfbc, t=0.25),
                jamr.sync(u, jtopo, jleaf, jfbc, homogeneous=True, t=0.25),
                jamr.fill_slaves(u, jtopo, jleaf, jfbc, t=0.25),
                jamr.sync_vof(f, jtopo, jleaf, jsbc),
                jamr.sync_faces(uf, jtopo, jleaf))
    # one compile of the five (cheaper than running them eagerly)
    want = jax.jit(reference)(_j(u), _j(f), _j(uf))
    got = (amr.sync(_t(u), topo, leaf, tfbc, t=0.25),
           amr.sync(_t(u), topo, leaf, tfbc, homogeneous=True, t=0.25),
           amr.fill_slaves(_t(u), topo, leaf, tfbc, t=0.25),
           amr.sync_vof(_t(f), topo, leaf, sbc),
           amr.sync_faces(_t(uf), topo, leaf))
    for k, (w, g) in enumerate(zip(want, got)):
        assert _err(w, g) < (1e-12 if k == 3 else 1e-14), k
    assert np.array_equal(
        np.asarray(jamr.covered_masks(jleaf, jtopo)[cg.lmin]),
        amr.covered_masks(leaf, topo)[cg.lmin].numpy())


@pytest.mark.parametrize("coef", ["unit", "alpha", "cell_dia"])
def test_leaf_residual_and_cycle_equal_the_reference(coef):
    """The leaf residual of a synced field (with the reflux) and one
    cycle on the ring mesh with the lid's BCs: unit coefficients, face
    coefficients, a cell dia."""
    jcg, cg, jfbc, tfbc = _setup("lid")
    u, rhs = _fields(cg, 3), _fields(cg, 4)
    kw = {}
    if coef == "alpha":
        a = _fields(cg, 5, faces=True)
        kw["alpha"] = {l: tuple(1.5 + np.tanh(x) for x in v)
                       for l, v in a.items()}
    elif coef == "cell_dia":
        kw["dia"] = {l: 20.0 + np.abs(v) for l, v in _fields(cg, 6).items()}
    jkw = {k: _j(v) for k, v in kw.items()}
    tkw = {k: _t(v) for k, v in kw.items()}
    leaf, jleaf = cg.leaf_arrays("cpu"), jcg.leaf_arrays()
    js = jamr.sync(_j(u), jcg.topo, jleaf, jfbc)
    want = jamr.leaf_residual(js, _j(rhs), jcg.topo, jleaf, jfbc, **jkw)
    got = amr.leaf_residual(amr.sync(_t(u), cg.topo, leaf, tfbc), _t(rhs),
                            cg.topo, leaf, tfbc, **tkw)
    assert _err(want, got) < TOL
    jp = jpoisson.MultilevelParams(nrelax=2, minlevel=1)
    tp = poisson.MultilevelParams(nrelax=2, minlevel=1)
    want = jax.jit(lambda uu, rr, kk: jamr.cycle(
        uu, rr, jcg.topo, jleaf, jfbc, jp, **kk))(_j(u), _j(rhs), jkw)
    got = amr.cycle(_t(u), _t(rhs), cg.topo, leaf, tfbc, tp, **tkw)
    assert _err(want, got) < TOL


@pytest.mark.parametrize("name", ["box", "sphere3d"])
def test_solve_equals_the_reference(name):
    """The tolerance solve (Neumann-y periodic-x box: the rhs's leaf mean
    removed; the 3D sphere with Dirichlet sides): the cycle count, the
    final residual and the field."""
    jcg, cg, jfbc, tfbc = _setup(name)
    rhs = _fields(cg, 7)
    jp = jpoisson.MultilevelParams(nrelax=2, tolerance=1e-4, nitermax=8)
    tp = poisson.MultilevelParams(nrelax=2, tolerance=1e-4, nitermax=8)
    ju, jn, jr = jax.jit(lambda r: jamr.solve(
        r, jcg.topo, jcg.leaf_arrays(), jfbc, jp))(_j(rhs))
    tu, stats = amr.solve(_t(rhs), cg.topo, cg.leaf_arrays("cpu"), tfbc, tp)
    assert stats.niter == int(jn)
    # one read of the condition a cycle past nitermin, none after the cap
    assert stats.host_syncs == stats.niter - (stats.niter == tp.nitermax)
    # the residual cancels: its distance against the rhs's scale
    scale = max(float(np.abs(v).max()) for v in rhs.values())
    assert abs(float(stats.rinf) - float(jr)) < TOL * scale
    assert _err(ju, tu) < TOL
