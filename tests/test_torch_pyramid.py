"""The restriction pyramid, ``restrict_pyramid`` (every level of a
residual pyramid in one kernel launch on the card), on the CPU in
float64: its plain version against the chain of one-level pools and
against the JAX package's own pyramid (gerris_tpu/ops/pallas/rbgs.py:
``_lane_pool(_row_pool(.))``, the cascades' in-VMEM restriction in
``_cp_core``); its input checks; and the 2D corrections
(``poisson.correction`` on each of its coarse branches, and
``_correction_variable``), which restrict through one pyramid call,
against the same corrections restricting through the chain of one-level
``restrict2`` calls they made before.

Bounds: the pool is a mean of four values with weights 0.5, exact in
binary floating point up to the two sums' rounding, and both sides sum
in the same order, so the plain pyramid is bit-identical to the chain;
the JAX pools compute the lane mean as a matrix product with 0.5
weights, bit-identical in float64 here too, bounded at 1e-15 of max|ref|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.ops.pallas import rbgs as jrbgs  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson  # noqa: E402

# (top size, levels): the cascades' 512 -> 16 cut to 256 -> 8, the
# adaptive correction's two levels, the twophase correction's down to 4^2
# and a whole pyramid down to 1^2
CASES = [(256, 5), (128, 2), (128, 5), (64, 6)]


def _field(seed, n):
    return np.random.default_rng(seed).standard_normal((n, n))


def _chain(r, levels):
    out = []
    for _ in range(levels):
        r = rbgs.pool_plain(r)
        out.append(r)
    return out


@pytest.mark.parametrize("n,levels", CASES)
def test_pyramid_is_the_pool_chain(n, levels):
    r = torch.from_numpy(_field(n + levels, n))
    want = _chain(r, levels)
    for got in (rbgs.pyramid_plain(r, levels),
                rbgs.restrict_pyramid(r, levels)):
        assert [tuple(t.shape) for t in got] == \
            [(n >> k, n >> k) for k in range(1, levels + 1)]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    r2 = torch.from_numpy(_field(n + levels + 1, n))
    pair = rbgs.restrict_pyramid_pair([r, r2], levels)
    assert all(torch.equal(a, b) for a, b in zip(pair[0], want))
    assert all(torch.equal(a, b) for a, b in zip(pair[1], _chain(r2, levels)))
    assert torch.equal(rbgs.restrict2(r), want[0])


@pytest.mark.parametrize("n,levels", CASES)
def test_pyramid_matches_the_jax_pools(n, levels):
    x = _field(2 * n + levels, n)
    ref, lv = [], jnp.asarray(x)
    for _ in range(levels):
        lv = jrbgs._lane_pool(jrbgs._row_pool(lv))
        ref.append(np.asarray(lv))
    got = rbgs.restrict_pyramid(torch.from_numpy(x), levels)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= 1e-15 * np.abs(b).max()


def test_pyramid_refuses_bad_levels():
    r = torch.zeros(64, 64, dtype=torch.float64)
    for levels in (0, 7, -1):        # none, or past 1x1
        with pytest.raises(ValueError, match="levels"):
            rbgs.restrict_pyramid(r, levels)
    with pytest.raises(ValueError, match="power of two"):
        rbgs.restrict_pyramid(torch.zeros(48, 48, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="multiple"):
        rbgs.restrict_pyramid(torch.zeros(96, 64, dtype=torch.float64), 2)
    # a box's level (n, 2n) is taken: the chain of one-level pools
    box = torch.arange(64.0 * 32, dtype=torch.float64).reshape(64, 32)
    for a, b in zip(rbgs.restrict_pyramid(box, 5),
                    rbgs.pyramid_plain(box, 5)):
        assert torch.equal(a, b) and a.shape[0] == 2 * a.shape[1]
    with pytest.raises(ValueError, match="levels"):
        rbgs.restrict_pyramid(box, 6)
    with pytest.raises(TypeError):
        rbgs.restrict_pyramid(r.half(), 2)
    with pytest.raises(ValueError):
        rbgs.restrict_pyramid_pair([r, torch.zeros(32, 32,
                                                   dtype=torch.float64)], 2)
    with pytest.raises(ValueError, match="levels"):
        rbgs.restrict_pyramid_pair([r, r], 7)


def _chained_levels(r, levels):
    """The corrections' restriction before the pyramid: one restrict2 call
    per level."""
    rs = [r]
    for _ in range(levels):
        rs.append(rbgs.restrict2(rs[-1]))
    return rs


def _lid_fbc():
    return bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                           top=bc.Dirichlet(1.0))


# each coarse branch of poisson.correction at 128^2: K12 at coarse_top
# 32 (two levels restricted), the dense 16^2 solve (three), relaxation
# from zero at minlevel 3 (four); periodic rows take the dense 8^2 solve
# and prolong + K10 upward
BRANCHES = {
    "k12": (_lid_fbc(), dict(coarse_top=32, dense_coarse_max=0), 2.5e4),
    "dense": (bc.FieldBC.uniform(bc.Neumann(), 2),
              dict(coarse_top=1 << 20, dense_coarse_max=256), None),
    "relax": (_lid_fbc(), dict(coarse_top=1 << 20, dense_coarse_max=0,
                               minlevel=3), 2.5e4),
    "periodic_rows": (bc.FieldBC(((bc.Periodic(), bc.Periodic()),
                                  (bc.Neumann(), bc.Neumann()))),
                      dict(dense_coarse_max=64), None),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_correction_restricts_through_one_pyramid(branch, monkeypatch):
    fbc, kw, dia = BRANCHES[branch]
    grid = Grid(level=7)
    params = poisson.MultilevelParams(nrelax=3, omega=1.5, coarsest_relax=8,
                                      **kw)
    r, u = (torch.from_numpy(_field(s, 128)) for s in (31, 32))
    calls = []
    pyramid = rbgs.restrict_pyramid

    def spied(x, levels):
        calls.append((x.shape[0], levels))
        return pyramid(x, levels)

    monkeypatch.setattr(rbgs, "restrict_pyramid", spied)
    got = poisson.correction(r, grid, fbc, params, dia, u_fine=u)
    assert len(calls) == 1 and calls[0][0] == 128
    monkeypatch.setattr(poisson, "_residual_levels", _chained_levels)
    want = poisson.correction(r, grid, fbc, params, dia, u_fine=u)
    assert len(calls) == 1
    assert torch.equal(got, want)


def test_correction_variable_restricts_through_one_pyramid(monkeypatch):
    """The alpha correction (K15 at every level on the card) down to
    minlevel 2 (4^2): one pyramid of five levels at 128^2."""
    grid = Grid(level=7)
    fbc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    params = poisson.MultilevelParams(nrelax=2, coarsest_relax=4, minlevel=2)
    rng = np.random.default_rng(33)
    r = torch.from_numpy(rng.standard_normal((128, 128)))
    alpha = (torch.from_numpy(0.5 + rng.random((129, 128))),
             torch.from_numpy(0.5 + rng.random((128, 129))))
    dia = torch.from_numpy(0.1 + rng.random((128, 128)))
    calls = []
    pyramid = rbgs.restrict_pyramid

    def spied(x, levels):
        calls.append(levels)
        return pyramid(x, levels)

    monkeypatch.setattr(rbgs, "restrict_pyramid", spied)
    got = poisson.correction(r, grid, fbc, params, dia, alpha=alpha)
    assert calls == [5]
    monkeypatch.setattr(poisson, "_residual_levels", _chained_levels)
    want = poisson.correction(r, grid, fbc, params, dia, alpha=alpha)
    assert calls == [5]
    assert torch.equal(got, want)
