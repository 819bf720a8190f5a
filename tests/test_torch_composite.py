"""The composite mesh descriptor (gerris_tpu_torch/solvers/composite.py)
against the JAX package's: the graded depth maps and leaf masks of depth
maps and refine functions (2D, 3D, a 1 x 3 box) equal bit for bit, the
host solve's history, the flattened field, and utils/convert's
composite_from_jax."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.solvers import composite as jcomp  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.solvers import composite as comp  # noqa: E402
from gerris_tpu_torch.solvers import poisson  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

MESHES = {
    "ring2d": (dict(level=3, dim=2), 6,
               lambda x, y, l: np.abs(np.sqrt(x * x + y * y) - 0.3)
               < 2.0 / (1 << l)),
    "capwave_box": (dict(level=3, dim=2, origin=(-0.5, -1.5),
                         extents=(1, 3)), 6,
                    lambda x, y, l: np.floor(7 - 4 * np.abs(y) / 1.5) > l),
    "sphere3d": (dict(level=2, dim=3), 4,
                 lambda x, y, z, l: x * x + y * y + z * z < 0.3 ** 2),
}


def _meshes(name):
    kw, lmax, fn = MESHES[name]
    return (jcomp.CompositeGrid.from_refine_fn(JGrid(**kw), lmax, fn),
            comp.CompositeGrid.from_refine_fn(Grid(**kw), lmax, fn))


@pytest.mark.parametrize("name", list(MESHES))
def test_refine_fn_meshes_equal_the_reference(name):
    jcg, cg = _meshes(name)
    assert (cg.lmin, cg.lmax) == (jcg.lmin, jcg.lmax)
    assert np.array_equal(cg.depth_map(), jcg.depth_map())
    for l in range(cg.lmin, cg.lmax + 1):
        assert np.array_equal(cg.leaf_np(l), jcg.leaf_np(l))
        assert np.array_equal(cg.active_np(l), np.asarray(jcg.active(l)))
    assert cg.n_leaves() == jcg.n_leaves()
    leaf = cg.leaf_arrays("cpu")
    assert all(leaf[l].dtype == torch.bool and leaf[l].device.type == "cpu"
               for l in leaf)
    assert convert.composite_from_jax(jcg) == cg


@pytest.mark.parametrize("dim", [2, 3])
def test_graded_depth_maps_equal_the_reference(dim):
    """Random depth maps: the grading fixpoint and the meshes built from
    them (graded or not), bit for bit."""
    rng = np.random.default_rng(dim)
    lmin, lmax = 2, 5 if dim == 2 else 4
    n = 1 << lmax
    D = rng.integers(lmin, lmax + 1, (n,) * dim).astype(np.int32)
    D = np.where(rng.random(D.shape) < 0.97, lmin, D).astype(np.int32)
    G = comp.grade_depth_map(D)
    assert np.array_equal(G, jcomp.grade_depth_map(D))
    assert (G >= D).all()
    cg = comp.CompositeGrid.from_depth_map(Grid(lmin, dim=dim), lmax, D)
    jcg = jcomp.CompositeGrid.from_depth_map(JGrid(lmin, dim=dim), lmax, D)
    assert cg == convert.composite_from_jax(jcg)
    assert np.array_equal(cg.depth_map(), jcg.depth_map())
    assert (cg.depth_map() >= G).all()


def test_composite_solve_and_flatten_equal_the_reference():
    """The host-looped solve of the ring mesh (Dirichlet, a seeded rhs):
    the residual history and the flattened field to 1e-11."""
    jcg, cg = _meshes("ring2d")
    rng = np.random.default_rng(5)
    rhs = {l: rng.standard_normal(cg.grid(l).shape)
           for l in range(cg.lmin, cg.lmax + 1)}
    jp = jpoisson.MultilevelParams(nrelax=2, nitermax=4, tolerance=0.0)
    tp = poisson.MultilevelParams(nrelax=2, nitermax=4, tolerance=0.0)
    jfbc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    tfbc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    ju, jh = jcomp.composite_solve({l: jnp.asarray(v) for l, v in rhs.items()},
                                   jcg, jfbc, jp)
    tu, th = comp.composite_solve({l: torch.tensor(v)
                                   for l, v in rhs.items()}, cg, tfbc, tp)
    assert len(th) == len(jh) == 4
    assert all(math.isclose(a, b, rel_tol=1e-11) for a, b in zip(th, jh))
    want = np.asarray(jcomp.flatten(ju, jcg, jfbc))
    got = comp.flatten(tu, cg, tfbc).numpy()
    assert float(np.abs(got - want).max()) < 1e-11 * np.abs(want).max()
