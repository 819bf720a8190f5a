"""Embedded solids (gerris_tpu_torch/physics/solid.py) against the JAX
package's gerris_tpu/physics/solid.py on the CPU in float64: the cell and
face fractions in 2D (the cylinder's 3 x 1 box, test/circle's disk) and
3D (a sphere), the cut segments' geometry, the Dirichlet terms, the
Dirichlet surface's probe, and the merged-cell update on the cylinder's
geometry, each to 1e-12 of max; and two faults of the reference that the
port does not copy, pinned on hand-built inputs: the 1e-300 guard of the
face fraction (0 in float32, so a saddle face is NaN there) and the
two-hop merge, which leaves a mutual pair of small cells or a long chain
of them unmerged."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.physics import solid as jsolid  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.physics import solid  # noqa: E402

RTOL = 1e-12


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(ref - got.numpy())) / max(np.max(np.abs(ref)),
                                                          1e-300))


def _cylinder_grids(level):
    kw = dict(dim=2, origin=(-0.5, -0.5), extents=(3, 1))
    return JGrid(level, **kw), Grid(level, **kw)


def _jcyl(x, y):
    return jnp.sqrt(x * x + y * y) - chip_smoke.CYLINDER_R


def _jdisk(x, y):
    return x * x + y * y - 0.0625


@pytest.mark.parametrize("case", ["cylinder", "disk"])
def test_fractions_2d_match_jax(case):
    """The volume and face fractions of the cylinder's box at level 4 (48
    x 16) and of test/circle's disk at level 5 (32^2) to 1e-12; the
    cylinder's fluid area within 1e-3 of 3 - pi R^2."""
    if case == "cylinder":
        jg, tg = _cylinder_grids(4)
        jphi, tphi = _jcyl, chip_smoke.cylinder_phi
    else:
        jg, tg = JGrid(5), Grid(5)
        jphi, tphi = _jdisk, chip_smoke.circle_phi
    a, s = jsolid.solid_fractions(jg, jphi)
    ta, ts = solid.solid_fractions(tg, tphi, device="cpu")
    assert _rel(a, ta) <= RTOL
    for f, g in zip(s, ts):
        assert g.shape == tuple(np.asarray(f).shape)
        assert _rel(f, g) <= RTOL
    if case == "cylinder":
        area = float(ta.sum()) * tg.h ** 2
        exact = 3.0 - math.pi * chip_smoke.CYLINDER_R ** 2
        assert abs(area - exact) < 1e-3 * exact


def test_fractions_3d_match_jax():
    """A sphere of radius 0.3 (fluid inside) at level 4 (16^3): the volume
    fractions and the three axes' face fractions to 1e-12."""
    a, s = jsolid.solid_fractions(
        JGrid(4, dim=3), lambda x, y, z, t=0.0: 0.3 - jnp.sqrt(
            x ** 2 + y ** 2 + z ** 2))
    ta, ts = solid.solid_fractions(
        Grid(4, dim=3), lambda x, y, z: 0.3 - torch.sqrt(x ** 2 + y ** 2
                                                          + z ** 2),
        device="cpu")
    assert _rel(a, ta) <= RTOL
    assert all(_rel(f, g) <= RTOL for f, g in zip(s, ts))
    assert bool(((ts[0] > 0) & (ts[0] < 1)).any())


def test_surface_geometry_and_dirichlet_terms_match_jax():
    """The cut segments' length and centre distance of test/circle's disk
    at level 5, and the Dirichlet terms with a callable surface value, to
    1e-12."""
    jg, tg = JGrid(5), Grid(5)
    length, dist = jsolid.surface_geometry(jg, _jdisk)
    tl, td = solid.surface_geometry(tg, chip_smoke.circle_phi, device="cpu")
    assert _rel(length, tl) <= RTOL and _rel(dist, td) <= RTOL
    assert int((tl > 0).sum()) == int(np.sum(np.asarray(length) > 0)) > 0
    dia, rhs = jsolid.dirichlet_terms(jg, _jdisk, lambda x, y: x * y + 1.0)
    tdia, trhs = solid.dirichlet_terms(tg, chip_smoke.circle_phi,
                                       lambda x, y: x * y + 1.0,
                                       device="cpu")
    assert _rel(dia, tdia) <= RTOL and _rel(rhs, trhs) <= RTOL


def test_dirichlet_surface_probe_matches_jax():
    """The cylinder's DirichletSurface at level 5 (96 x 32): its dia, the
    surface points and, on the mixed cells (the only cells where the
    reference reads it), the probe of a seeded field and the deferred
    correction dia (probe(u) - u), to 1e-12; 0 elsewhere."""
    jg, tg = _cylinder_grids(5)
    jds = jsolid.DirichletSurface(jg, _jcyl)
    tds = solid.DirichletSurface(tg, chip_smoke.cylinder_phi, device="cpu")
    mixed = np.asarray(jds.mixed)
    assert np.array_equal(mixed, tds.mixed.numpy()) and mixed.sum() > 0
    assert _rel(jds.dia, tds.dia) <= RTOL
    for f, g in zip(jds.surf_xy, tds.surf_xy):
        assert _rel(np.where(mixed, f, 0.0), torch.where(tds.mixed, g, 0.0)) \
            <= RTOL
    u = np.random.default_rng(5).standard_normal(jg.shape)
    tu = torch.from_numpy(u)
    ref = np.where(mixed, jds.probe(jnp.asarray(u)), 0.0)
    got = tds.probe(tu)
    assert _rel(ref, got) <= RTOL and not got[~tds.mixed].any()
    corr = np.where(mixed, jds.dia * (jds.probe(jnp.asarray(u)) - u), 0.0)
    assert _rel(corr, tds.correction(tu)) <= RTOL


def test_saddle_face_float32_has_no_nan():
    """A reference fault (gerris_tpu/physics/solid.py:56): the 3D face
    fraction guards the normal's 1-norm with 1e-300, which is 0 in
    float32, so a saddle face (gx = gy = 0 with corners of both signs:
    p00 = p11 = 1, p10 = p01 = -1) is 0/0 = NaN there and clip keeps it.
    The port guards with the dtype's tiny: the face is finite, and its
    float32 value is its float64 one."""
    p = [1.0, -1.0, -1.0, 1.0]          # p00, p10, p01, p11
    ref32 = jsolid._face_fraction_2d(*(jnp.asarray([v], jnp.float32)
                                       for v in p))
    assert bool(jnp.isnan(ref32).all())             # the reference's fault
    got32 = solid._face_fraction_2d(*(torch.tensor([v], dtype=torch.float32)
                                      for v in p))
    got64 = solid._face_fraction_2d(*(torch.tensor([v], dtype=torch.float64)
                                      for v in p))
    assert bool(torch.isfinite(got32).all())
    assert float(got32[0]) == float(got64[0])
    assert float(got64[0]) == float(jsolid._face_fraction_2d(
        *(jnp.asarray([v]) for v in p))[0])


def test_merge_on_cylinder_geometry_matches_jax():
    """The cylinder at level 7 (384 x 128): its small cut cells all merge
    into a neighbour that is not small (no mutual pair, no chain), so the
    port's transitive merge and the reference's two hops give the same
    groups, and the merged-cell update of a seeded field and increment
    agrees to 1e-12.  Both take the JAX package's fractions: a small cell
    between two neighbours of equal fraction by symmetry picks the larger
    of the two, so the last bit of the fractions (the packages' differ
    by 1e-16) decides which."""
    jg, tg = _cylinder_grids(7)
    a, s = jsolid.solid_fractions(jg, _jcyl)
    ta, ts = solid.solid_fractions(tg, chip_smoke.cylinder_phi, device="cpu")
    small, tgt = solid._merge_targets(ta, ts)
    src = torch.nonzero(small.reshape(-1)).squeeze(1)
    dst = tgt.reshape(-1)[src]
    assert src.numel() > 0
    assert int(small.reshape(-1)[dst].sum()) == 0       # no small target
    mutual = small.reshape(-1)[dst] & (tgt.reshape(-1)[dst] == src)
    assert int(mutual.sum()) == 0
    groups = solid.merge_groups(ta, ts)
    assert groups.ngroups == src.numel() and groups.index.shape[1] >= 2
    rng = np.random.default_rng(11)
    v, fv = rng.standard_normal(jg.shape), rng.standard_normal(jg.shape)
    ref = jsolid.merged_cell_update(jnp.asarray(v), jnp.asarray(fv), a, s)
    got = solid.merged_cell_update(
        torch.from_numpy(v), torch.from_numpy(fv), torch.from_numpy(
            np.array(a)), tuple(torch.from_numpy(np.array(f)) for f in s))
    assert _rel(ref, got) <= RTOL


def _row_system(avals):
    """A 3-row grid whose middle row holds the cells ``avals`` (the rest
    solid), the x faces between consecutive fluid cells open (s = 1) and
    every other face closed."""
    n = len(avals)
    a = np.zeros((n, 3))
    a[:, 1] = avals
    sx = np.zeros((n + 1, 3))
    for i in range(n - 1):
        if avals[i] > 0 and avals[i + 1] > 0:
            sx[i + 1, 1] = 1.0
    sy = np.zeros((n, 4))
    return a, (sx, sy)


def _both(a, s, seed):
    rng = np.random.default_rng(seed)
    v, fv = rng.standard_normal(a.shape), rng.standard_normal(a.shape)
    ref = np.asarray(jsolid.merged_cell_update(
        jnp.asarray(v), jnp.asarray(fv), jnp.asarray(a),
        tuple(jnp.asarray(f) for f in s)))
    got = solid.merged_cell_update(torch.from_numpy(v), torch.from_numpy(fv),
                                   torch.from_numpy(a),
                                   tuple(torch.from_numpy(f) for f in s))
    return v, fv, ref, got.numpy()


def test_merge_mutual_pair_reference_fault():
    """A reference fault (gerris_tpu/physics/solid.py:350-351): two small
    cells that are each other's only open neighbour pick each other, and
    two pointer jumps return each to itself, so each divides by its own
    small fraction.  The port merges them into one group: both take
    (a0 v0 + f0 + a1 v1 + f1) / (a0 + a1).  The solid cells keep v."""
    a, s = _row_system([0.0, 0.2, 0.3, 0.0])
    v, fv, ref, got = _both(a, s, 3)
    cells = [(1, 1), (2, 1)]
    single = [(a[c] * v[c] + fv[c]) / a[c] for c in cells]
    assert np.allclose([ref[c] for c in cells], single, rtol=1e-14)
    group = sum(a[c] * v[c] + fv[c] for c in cells) / sum(a[c] for c in cells)
    assert np.allclose([got[c] for c in cells], group, rtol=1e-14)
    solid_ = a == 0.0
    assert np.array_equal(got[solid_], v[solid_])


def test_merge_long_chain_reference_fault():
    """A reference fault (gerris_tpu/physics/solid.py:350-351): a chain of
    six small cells, each merging into its larger neighbour, ending at a
    full cell.  Two pointer jumps take each cell four links on, so the
    first cells stop at small cells that are not the root and average
    alone; the port puts the whole chain and its full cell in one group.
    Where the chain is three links or fewer, both agree."""
    chain = [0.04, 0.08, 0.12, 0.16, 0.2, 0.24, 1.0, 1.0]
    a, s = _row_system(chain)
    v, fv, ref, got = _both(a, s, 4)
    cells = [(i, 1) for i in range(7)]
    group = sum(a[c] * v[c] + fv[c] for c in cells) / sum(a[c] for c in cells)
    assert np.allclose([got[c] for c in cells], group, rtol=1e-14)
    first = (a[0, 1] * v[0, 1] + fv[0, 1]) / a[0, 1]
    assert np.isclose(ref[0, 1], first, rtol=1e-14)
    assert not np.isclose(ref[0, 1], group)
    short = [0.0, 0.12, 0.2, 0.24, 1.0, 1.0]      # three links to the root
    a, s = _row_system(short)
    _, _, ref, got = _both(a, s, 5)
    assert np.max(np.abs(ref - got)) <= 1e-13 * np.max(np.abs(ref))
