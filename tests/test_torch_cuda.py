"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips, with the reason, where torch has no CUDA
device (the CPU test run).  On a machine with a card:
    python -m pytest tests/test_torch_cuda.py -q
Tolerances: float64 1e-12 and float32 1e-5 (1e-4 for the cascade, whose
40 coarsest sweeps accumulate rounding, as K12's do) of max|plain|, and
of sum|div| for a divergence's total; tiled and whole-level K3 and K10
launches are bit-identical, and so are K4's div across block shapes and
K11's residual against K1's r0, and K17 across tiles.  A kernel given BCs
outside its encoding raises.  The adaptive solve on the card is held to
the same solve through the plain versions, and so are three steps of the
3D lid cavity (K13, the 3D smoother, at every level above the dense
one); three steps of the fold route (K16, K2, K17 per projection) are
held to the unfolded route.  K15, the variable-coefficient smoother, is
held to its plain version on every periodicity, dia mode and level size
of a two-phase correction, bit-identical across tiles, and three
two-phase steps on the card to the same steps on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg, predict, projops, rbgs  # noqa: E402

pytestmark = pytest.mark.cuda

SIGNS_LID = (-1.0, -1.0, -1.0, -1.0)
OFFS_LID = (0.0, 0.0, 0.0, 2.0)
BOUND = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rnd(dev, dtype, seed, *shapes):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev, dtype=dtype)
            for s in shapes]


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_y", [False, True])
def test_residual_restrict_kernel(dev, dtype, per_y):
    n = 256
    u, rhs, sub = _rnd(dev, dtype, 1, (n, n), (n, n), (1,))
    kw = dict(h2=1.0 / n ** 2, signs=SIGNS_LID, offs=OFFS_LID, per_y=per_y)
    rbgs.reset_launch_counts()
    got = rbgs.residual_restrict(u, rhs, 0.6, sub, **kw)
    assert rbgs.LAUNCHES["residual_restrict"] == 1
    ref = rbgs.residual_restrict_plain(u, rhs, 0.6, sub, **kw)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,coarse,add_u,per_y", [
    (256, True, True, False), (256, True, False, True),
    (64, True, False, False), (16, False, False, False)])
def test_prolong_relax_kernel(dev, dtype, n, coarse, add_u, per_y):
    c, rhs, u = _rnd(dev, dtype, 2, (n // 2, n // 2), (n, n), (n, n))
    c = c if coarse else None
    u = u if add_u else None
    nsweeps = 5 if coarse else 40
    kw = dict(nsweeps=nsweeps, h2=1.0 / n ** 2, signs=(-1.0, 1.0, 1.0, -1.0),
              per_y=per_y, omega=1.5)
    got = rbgs.prolong_relax(c, rhs, 0.3, u, **kw)
    ref = rbgs.prolong_relax_plain(c, rhs, 0.3, u, **kw)
    assert _rel(got, ref) <= BOUND[dtype]


def test_prolong_relax_tile_invariance(dev):
    c, rhs, u = _rnd(dev, torch.float32, 3, (128, 128), (256, 256),
                     (256, 256))
    kw = dict(nsweeps=5, h2=1.0 / 256 ** 2, signs=SIGNS_LID, omega=1.5)
    a = rbgs.prolong_relax(c, rhs, 0.0, u, tile=32, **kw)
    b = rbgs.prolong_relax(c, rhs, 0.0, u, tile=16, **kw)
    assert torch.equal(a, b)
    c, rhs = _rnd(dev, torch.float32, 4, (32, 32), (64, 64))
    whole = rbgs.prolong_relax(c, rhs, 0.0, **kw)
    tiled = rbgs.prolong_relax(c, rhs, 0.0, tile=16, whole_max=32, **kw)
    assert torch.equal(whole, tiled)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cascade_and_restrict_kernels(dev, dtype):
    r1, r2 = _rnd(dev, dtype, 5, (256, 256), (128, 128))
    kw = dict(nsweeps=5, coarsest=40, h2_half=1.0 / 256 ** 2,
              signs=SIGNS_LID, omega=1.5)
    rbgs.reset_launch_counts()
    got = rbgs.cascade_prolong_relax(r1, r2, 0.0, **kw)
    # 128 -> 64 -> 32 -> 16: three pools, then 16 (from zero), 32, 64,
    # 128 and the n/2 level
    assert rbgs.LAUNCHES["cascade_prolong_relax"] == 1
    assert rbgs.LAUNCHES["restrict2"] == 3
    assert rbgs.LAUNCHES["cascade.prolong_relax"] == 5
    assert rbgs.LAUNCHES["prolong_relax"] == 0
    ref = rbgs.cascade_prolong_relax_plain(r1, r2, 0.0, **kw)
    bound = 1e-4 if dtype == torch.float32 else 1e-12
    assert _rel(got, ref) <= bound
    assert _rel(rbgs.restrict2(r1), rbgs.pool_plain(r1)) <= BOUND[dtype]


# --- the predictor, projection and advection kernels (K6, K4, K5, K9, K14)


def _velocity_bcs(per_y):
    """The lid cavity's velocity BCs, or Dirichlet x walls with periodic
    y."""
    if per_y:
        per = (bc.Periodic(), bc.Periodic())
        return (bc.FieldBC(((bc.Dirichlet(0.5), bc.Dirichlet(-0.25)), per)),
                bc.FieldBC(((bc.Dirichlet(0.1), bc.Dirichlet(0.0)), per)))
    return (bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                            top=bc.Dirichlet(1.0)),
            bc.FieldBC.uniform(bc.Dirichlet(0.0), 2))


def _check_div(got, ref, dtype):
    """(div, total) pairs: div as every output, total against sum|div|."""
    assert _rel(got[0], ref[0]) <= BOUND[dtype]
    scale = float(ref[0].abs().sum())
    assert float((got[1] - ref[1]).abs()) <= BOUND[dtype] * scale


# 256^2, and a 72 x 100 grid that no block tiles (ragged edges in both
# axes)
GRIDS = [Grid(level=8), Grid(level=2, extents=(18, 25))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_y", [False, True])
@pytest.mark.parametrize("grid", GRIDS)
def test_predict_xy_kernel(dev, dtype, per_y, grid):
    U, V = _rnd(dev, dtype, 6, grid.shape, grid.shape)
    dt = 0.4 * grid.h
    u_bcs = _velocity_bcs(per_y)
    predict.reset_launch_counts()
    got = predict.predict_xy(U, V, dt, grid, u_bcs, 2.0 / (grid.h * dt))
    assert predict.LAUNCHES["predict_xy"] == 1
    ref = predict.predict_xy_plain(U, V, dt, grid, u_bcs,
                                   2.0 / (grid.h * dt))
    for a, b in zip(got[:2], ref[:2]):
        assert _rel(a, b) <= BOUND[dtype]
    _check_div(got[2:], ref[2:], dtype)
    faces = predict.predict_xy(U, V, dt, grid, u_bcs)
    assert all(torch.equal(a, b) for a, b in zip(faces[:2], got[:2]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", GRIDS)
def test_divergence_mac_kernel(dev, dtype, grid):
    n0, n1 = grid.shape
    ufx, ufy = _rnd(dev, dtype, 7, (n0 + 1, n1), (n0, n1 + 1))
    projops.reset_launch_counts()
    got = projops.divergence_mac(ufx, ufy, 0.01, grid.h)
    assert projops.LAUNCHES["divergence_mac"] == 1
    _check_div(got, projops.divergence_mac_plain(ufx, ufy, 0.01, grid.h),
               dtype)
    # another block shape: the same div bit for bit, the same total in
    # every run of one shape
    other = projops.divergence_mac(ufx, ufy, 0.01, grid.h, block=(16, 16))
    assert torch.equal(other[0], got[0])
    again = projops.divergence_mac(ufx, ufy, 0.01, grid.h, block=(16, 16))
    assert torch.equal(again[1], other[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_cells", [False, True])
@pytest.mark.parametrize("per_y", [False, True])
@pytest.mark.parametrize("grid", GRIDS)
def test_correct_project_kernel(dev, dtype, with_cells, per_y, grid):
    n0, n1 = grid.shape
    p, ufx, ufy, U, V = _rnd(dev, dtype, 8, grid.shape, (n0 + 1, n1),
                             (n0, n1 + 1), grid.shape, grid.shape)
    cells = (U, V) if with_cells else None
    y = (bc.Periodic(), bc.Periodic()) if per_y else \
        (bc.Neumann(), bc.Dirichlet(-1.0))
    p_bc = bc.FieldBC(((bc.Neumann(), bc.Dirichlet(0.25)), y))
    projops.reset_launch_counts()
    got = projops.correct_project(p, ufx, ufy, 0.003, grid, p_bc, cells)
    assert projops.LAUNCHES["correct_project"] == 1
    ref = projops.correct_project_plain(p, ufx, ufy, 0.003, grid, p_bc,
                                        cells)
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        if a is None:
            assert b is None and not with_cells
        else:
            assert _rel(a, b) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("use_gp", [False, True])
@pytest.mark.parametrize("per_y", [False, True])
@pytest.mark.parametrize("grid", GRIDS)
def test_interp_faces_kernel(dev, dtype, use_gp, per_y, grid):
    U, V, Gx, Gy = _rnd(dev, dtype, 9, *[grid.shape] * 4)
    gp = (Gx, Gy) if use_gp else None
    u_bcs = _velocity_bcs(per_y)
    dtv = 0.2 * grid.h
    projops.reset_launch_counts()
    got = projops.interp_faces(U, V, grid, u_bcs, gp, dtv, 1.0 / grid.h ** 2)
    assert projops.LAUNCHES["interp_faces"] == 1
    ref = projops.interp_faces_plain(U, V, grid, u_bcs, gp, dtv,
                                     1.0 / grid.h ** 2)
    for a, b in zip(got[:4], ref[:4]):
        assert _rel(a, b) <= BOUND[dtype]
    _check_div(got[4:], ref[4:], dtype)
    plain = projops.interp_faces(U, V, grid, u_bcs, gp, dtv)
    assert all(torch.equal(a, b) for a, b in zip(plain[:4], got[:4]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("folds", [False, True])
@pytest.mark.parametrize("c", [0, 1])
@pytest.mark.parametrize("grid", GRIDS)
def test_advect2d_kernel(dev, dtype, folds, c, grid):
    """Component c of the lid's velocity, with the gmac correction g;
    ``folds``: also the gp and oscale folds of the diffusion rhs."""
    n0, n1 = grid.shape
    v, ufx, ufy, g, gp = _rnd(dev, dtype, 10, grid.shape, (n0 + 1, n1),
                              (n0, n1 + 1), grid.shape, grid.shape)
    fbc = _velocity_bcs(False)[c]
    dt = 0.3 * grid.h
    kw = dict(g=g, gp=gp if folds else None,
              oscale=-1.0 / (dt * 1e-3) if folds else None)
    bcg.reset_launch_counts()
    got = bcg.advect2d(v, c, ufx, ufy, dt, grid, fbc, **kw)
    assert bcg.LAUNCHES["advect2d"] == 1
    ref = bcg.advect2d_plain(v, c, ufx, ufy, dt, grid, fbc, **kw)
    assert _rel(got, ref) <= BOUND[dtype]


def test_kernels_refuse_bcs_outside_their_scope(dev):
    """A CUDA tensor with BCs a kernel does not encode raises: the route
    choice belongs to the caller, and no wrapper falls back."""
    grid = GRIDS[0]
    U, V = _rnd(dev, torch.float32, 11, grid.shape, grid.shape)
    outflow = (bc.FieldBC(((bc.Dirichlet(1.0), bc.Neumann()),
                           (bc.Dirichlet(0.0), bc.Dirichlet(0.0)))),
               _velocity_bcs(False)[1])
    with pytest.raises(ValueError, match="outside the kernel's scope"):
        predict.predict_xy(U, V, 0.01, grid, outflow)
    with pytest.raises(ValueError, match="outside the kernel's scope"):
        bcg.advect2d(U, 0, *_rnd(dev, torch.float32, 12,
                                 grid.face_shape(0), grid.face_shape(1)),
                     0.01, grid, _velocity_bcs(True)[0])


# --- the U+V pair kernels (K7, K8a-c) and the pair solve


def _lid_pair():
    """The lid's U and V BCs with their K8 ghost encodings: shared signs,
    U's lid offset 2.0 on the top side, V's none."""
    from gerris_tpu_torch.solvers.poisson import _signs_offs
    fbcs = _velocity_bcs(False)
    grid = GRIDS[0]
    offss = [_signs_offs(grid, f, homogeneous=False)[1] for f in fbcs]
    return fbcs, _signs_offs(grid, fbcs[0], homogeneous=False)[0], offss


def _check_all(got, ref, dtype):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _check_all(a, b, dtype)
    else:
        assert got.shape == ref.shape
        assert _rel(got, ref) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rr,grid", [(False, GRIDS[0]), (False, GRIDS[1]),
                                     (True, GRIDS[0])])
def test_advect2d_pair_kernel(dev, dtype, rr, grid):
    """K7 with the lid's U and V BCs, g, gp and oscale, against its plain
    version and against two K14 launches; ``rr``: the rr_dia mode, which
    takes whole 16x16 tiles only (the ragged grid raises, below)."""
    n0, n1 = grid.shape
    v0, v1, ufx, ufy, g0, g1, gp0, gp1 = _rnd(
        dev, dtype, 13, grid.shape, grid.shape, (n0 + 1, n1), (n0, n1 + 1),
        *[grid.shape] * 4)
    fbcs = _velocity_bcs(False)
    dt = 0.3 * grid.h
    dia = 1.0 / (dt * 1e-3)
    kw = dict(g=(g0, g1), gp=(gp0, gp1), oscale=-dia,
              rr_dia=dia if rr else None)
    bcg.reset_launch_counts()
    got = bcg.advect2d_pair(v0, v1, ufx, ufy, dt, grid, fbcs, **kw)
    assert bcg.LAUNCHES == {"advect2d": 0, "advect2d_pair": 1}
    _check_all(got, bcg.advect2d_pair_plain(v0, v1, ufx, ufy, dt, grid,
                                            fbcs, **kw), dtype)
    k14 = [bcg.advect2d(v, c, ufx, ufy, dt, grid, fbcs[c], g=g, gp=gp,
                        oscale=-dia)
           for c, (v, g, gp) in enumerate(((v0, g0, gp0), (v1, g1, gp1)))]
    if rr:
        k14 = rbgs.residual_restrict_pair(
            [v0, v1], k14, [dia, dia], h2=grid.h ** 2, signs=_lid_pair()[1],
            offss=_lid_pair()[2])
    _check_all(got, k14, dtype)


def test_advect2d_pair_rr_needs_whole_tiles(dev):
    grid = GRIDS[1]
    n0, n1 = grid.shape
    v, ufx, ufy = _rnd(dev, torch.float32, 14, grid.shape, (n0 + 1, n1),
                       (n0, n1 + 1))
    with pytest.raises(ValueError, match="tiles"):
        bcg.advect2d_pair(v, v, ufx, ufy, 0.01, grid, _velocity_bcs(False),
                          oscale=-1.0, rr_dia=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_multigrid_kernels(dev, dtype):
    """K8a, K8b and K8c with their own dia, sub and ghost offsets per
    system, each against its plain version; each system of a pair launch
    is bit-identical to the single kernel's launch on that system."""
    n = 256
    _, signs, offss = _lid_pair()
    dias, h2 = [0.6, 0.9], 1.0 / n ** 2
    us = _rnd(dev, dtype, 15, (n, n), (n, n))
    rhss = _rnd(dev, dtype, 16, (n, n), (n, n))
    subs = [0.0, _rnd(dev, dtype, 17, (1,))[0]]
    rbgs.reset_launch_counts()
    rr = rbgs.residual_restrict_pair(us, rhss, dias, subs, h2=h2,
                                     signs=signs, offss=offss)
    _check_all(rr, rbgs.residual_restrict_pair_plain(
        us, rhss, dias, subs, h2=h2, signs=signs, offss=offss), dtype)
    for b in range(2):
        single = rbgs.residual_restrict(us[b], rhss[b], dias[b], subs[b],
                                        h2=h2, signs=signs, offs=offss[b])
        assert all(torch.equal(rr[k][b], single[k]) for k in range(3))
    ckw = dict(nsweeps=1, coarsest=40, h2_half=4 * h2, signs=signs)
    du = rbgs.cascade_prolong_relax_pair(rr[1], rr[2], dias, **ckw)
    ref = rbgs.cascade_prolong_relax_pair_plain(rr[1], rr[2], dias, **ckw)
    bound = 1e-4 if dtype == torch.float32 else 1e-12
    assert all(_rel(a, b) <= bound for a, b in zip(du, ref))
    for b in range(2):
        assert torch.equal(du[b], rbgs.cascade_prolong_relax(
            rr[1][b], rr[2][b], dias[b], **ckw))
    pkw = dict(nsweeps=1, h2=h2, signs=signs)
    out = rbgs.prolong_relax_pair(du, rr[0], dias, us, **pkw)
    _check_all(out, rbgs.prolong_relax_pair_plain(du, rr[0], dias, us,
                                                  **pkw), dtype)
    for b in range(2):
        assert torch.equal(out[b], rbgs.prolong_relax(du[b], rr[0][b],
                                                      dias[b], us[b], **pkw))
    # r2 64 -> 32 -> 16: two pair pools, then 16 (from zero), 32, 64 and
    # the n/2 = 128 level
    assert rbgs.LAUNCHES["residual_restrict_pair"] == 1
    assert rbgs.LAUNCHES["cascade_prolong_relax_pair"] == 1
    assert rbgs.LAUNCHES["restrict2_pair"] == 2
    assert rbgs.LAUNCHES["cascade_pair.prolong_relax"] == 4
    assert rbgs.LAUNCHES["prolong_relax_pair"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prolong_relax_pair_tile_invariance(dev, dtype):
    c0, c1, r0, r1, u0, u1 = _rnd(dev, dtype, 18, *[(128, 128)] * 2,
                                  *[(256, 256)] * 4)
    kw = dict(nsweeps=5, h2=1.0 / 256 ** 2, signs=SIGNS_LID, omega=1.5)
    a = rbgs.prolong_relax_pair([c0, c1], [r0, r1], [0.2, 0.4], [u0, u1],
                                tile=32, **kw)
    b = rbgs.prolong_relax_pair([c0, c1], [r0, r1], [0.2, 0.4], [u0, u1],
                                tile=16, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_relax_pair_kernels(dev, dtype):
    """The "relax" solver's pair solve on the card against the same solve
    through the plain versions (CPU tensors of the same values)."""
    from gerris_tpu_torch.solvers import poisson
    grid = GRIDS[0]
    fbcs = _velocity_bcs(False)
    dia = 1.0 / (0.8 * grid.h * 1e-3)
    us = _rnd(dev, dtype, 19, grid.shape, grid.shape)
    rhss = [-(u + 0.01 * r) * dia
            for u, r in zip(us, _rnd(dev, dtype, 20, grid.shape,
                                     grid.shape))]
    params = poisson.MultilevelParams(nrelax=2, solver="relax")
    rbgs.reset_launch_counts()
    got, _ = poisson.solve_relax_pair(us, rhss, grid, fbcs, params,
                                      [dia, dia])
    assert rbgs.LAUNCHES["residual_restrict_pair"] == 1
    assert rbgs.LAUNCHES["prolong_relax_pair"] == 1
    ref, _ = poisson.solve_relax_pair([u.cpu() for u in us],
                                      [r.cpu() for r in rhss], grid, fbcs,
                                      params, [dia, dia])
    for a, b in zip(got, ref):
        assert _rel(a.cpu(), b) <= BOUND[dtype]


# --- the adaptive solve's kernels: K11 residual, K10 rbgs_relax, K12
# coarse_vcycle ---------------------------------------------------------------------

PERIODIC_CASES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", PERIODIC_CASES)
def test_residual_kernel(dev, dtype, periodic):
    n = 256
    u, rhs = _rnd(dev, dtype, 21, (n, n), (n, n))
    kw = dict(h2=1.0 / n ** 2, signs=(-1.0, 1.0, -1.0, 1.0),
              offs=(0.2, -0.3, 0.0, 2.0), periodic=periodic)
    rbgs.reset_launch_counts()
    got = rbgs.residual(u, rhs, 0.7, **kw)
    assert rbgs.LAUNCHES["residual"] == 1
    assert _rel(got, rbgs.residual_plain(u, rhs, 0.7, **kw)) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_y", [False, True])
def test_residual_is_k1_r0(dev, dtype, per_y):
    """K11 and K1 compute a cell through one expression: K1's r0 with sub
    = 0 is K11's residual bit for bit."""
    n = 512
    u, rhs = _rnd(dev, dtype, 22, (n, n), (n, n))
    kw = dict(h2=1.0 / n ** 2, signs=SIGNS_LID, offs=OFFS_LID)
    r0 = rbgs.residual_restrict(u, rhs, 0.6, 0.0, per_y=per_y, **kw)[0]
    r = rbgs.residual(u, rhs, 0.6, periodic=(False, per_y), **kw)
    assert torch.equal(r0, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,nsweeps", [(256, 5), (64, 8), (16, 20)])
@pytest.mark.parametrize("periodic", PERIODIC_CASES)
def test_rbgs_relax_kernel(dev, dtype, n, nsweeps, periodic):
    u, rhs = _rnd(dev, dtype, 23, (n, n), (n, n))
    kw = dict(nsweeps=nsweeps, h2=1.0 / n ** 2,
              signs=(-1.0, 1.0, 1.0, -1.0), periodic=periodic, omega=1.2)
    rbgs.reset_launch_counts()
    got = rbgs.rbgs_relax(u, rhs, 0.3, **kw)
    assert rbgs.LAUNCHES["rbgs_relax"] == 1
    assert _rel(got, rbgs.rbgs_relax_plain(u, rhs, 0.3, **kw)) <= \
        BOUND[dtype]


@pytest.mark.parametrize("periodic", PERIODIC_CASES)
def test_rbgs_relax_tile_invariance(dev, periodic):
    """Bit-identical across tiles 32 and 16, whole-level and tiled, and
    one launch against several (sweeps split when their halo outgrows
    shared memory)."""
    u, rhs = _rnd(dev, torch.float64, 24, (256, 256), (256, 256))
    kw = dict(nsweeps=5, h2=1.0 / 256 ** 2, signs=SIGNS_LID,
              periodic=periodic, omega=1.5)
    assert torch.equal(rbgs.rbgs_relax(u, rhs, 0.1, tile=32, **kw),
                       rbgs.rbgs_relax(u, rhs, 0.1, tile=16, **kw))
    u64, r64 = u[:64, :64].contiguous(), rhs[:64, :64].contiguous()
    assert torch.equal(rbgs.rbgs_relax(u64, r64, 0.1, **kw),
                       rbgs.rbgs_relax(u64, r64, 0.1, tile=16, whole_max=32,
                                       **kw))
    kw["nsweeps"] = 30
    rbgs.reset_launch_counts()
    split = rbgs.rbgs_relax(u, rhs, 0.1, **kw)
    assert rbgs.LAUNCHES["rbgs_relax"] == 2      # 21 + 9 sweeps in float64
    assert torch.equal(split, rbgs.rbgs_relax(u, rhs, 0.1, tile=16, **kw))
    assert _rel(split, rbgs.rbgs_relax_plain(u, rhs, 0.1, **kw)) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [512, 128, 64, 16])
@pytest.mark.parametrize("per_y", [False, True])
def test_coarse_vcycle_kernel(dev, dtype, n, per_y):
    """K12 against its plain ladder: 3 + 1 + 3 launches at 512^2, the
    block kernel alone at 64^2 and below.  Its 40 coarsest sweeps
    accumulate float32 rounding, as K2's do (1e-4)."""
    (r,) = _rnd(dev, dtype, 25, (n, n))
    signs = (-1.0, 1.0, 1.0, 1.0) if per_y else SIGNS_LID
    kw = dict(nsweeps=5, coarsest=40, h2=1.0 / n ** 2, signs=signs,
              per_y=per_y, min_n=16)
    rbgs.reset_launch_counts()
    got = rbgs.coarse_vcycle(r, 0.4, **kw)
    levels = {512: 3, 128: 1}.get(n, 0)
    assert rbgs.LAUNCHES["coarse_vcycle.restrict2"] == levels
    assert rbgs.LAUNCHES["coarse_block"] == 1
    assert rbgs.LAUNCHES["coarse_vcycle.prolong_relax"] == levels
    bound = 1e-12 if dtype == torch.float64 else 1e-4
    assert _rel(got, rbgs.coarse_vcycle_plain(r, 0.4, **kw)) <= bound


@pytest.mark.parametrize("dtype,kind", [(torch.float64, "lid"),
                                        (torch.float64, "periodic"),
                                        (torch.float32, "lid")])
def test_adaptive_solve_on_the_card(dev, dtype, kind):
    """The adaptive solve at 1024^2 on the card against the same solve on
    the card through the plain versions: the lid's U diffusion system
    (K11, K12, K3; rhs -dia (u + du) as the step builds it) and a doubly
    periodic one (K11, the dense 64^2 solve, prolong + K10).  Float64
    to 1e-8: equal cycle counts and 1e-10 of max|u|.  Float32 to the
    path's 1e-3: the counts within one (rounding can move the last
    check) and the tolerance reached.  A periodic float32 system of
    white noise cannot reach 1e-3: its residual's rounding (eps * 4|u|/h^2)
    is above it."""
    from gerris_tpu_torch.solvers import poisson
    n = 1024
    grid = Grid(level=10)
    u, noise = _rnd(dev, dtype, 26, (n, n), (n, n))
    if kind == "lid":
        fbc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                              top=bc.Dirichlet(1.0))
        dia = 1.0 / (0.8 * grid.h * 1e-3)
        rhs = -dia * (u + 0.01 * noise)
    else:
        fbc = bc.FieldBC.uniform(bc.Periodic(), 2)
        dia = None
        rhs = noise - noise.mean()
    params = poisson.MultilevelParams(
        tolerance=1e-8 if dtype == torch.float64 else 1e-3)
    rbgs.reset_launch_counts()
    got, st = poisson.solve(u, rhs, grid, fbc, params, dia=dia)
    assert rbgs.LAUNCHES["residual"] == st.niter + 1
    assert rbgs.LAUNCHES["coarse_vcycle"] == (st.niter if kind == "lid"
                                              else 0)
    swaps = ("residual", "rbgs_relax", "coarse_vcycle", "prolong_relax",
             "restrict2")
    saved = {k: getattr(rbgs, k) for k in swaps}
    for k in swaps:
        setattr(rbgs, k, getattr(rbgs, k + "_plain" if k != "restrict2"
                                 else "pool_plain"))
    try:
        ref, rst = poisson.solve(u, rhs, grid, fbc, params, dia=dia)
    finally:
        for k, fn in saved.items():
            setattr(rbgs, k, fn)
    tol = params.tolerance * float(rhs.abs().max())
    assert float(st.residual_after["infty"]) <= tol
    if dtype == torch.float64:
        assert st.niter == rst.niter
        assert _rel(got, ref) <= 1e-10
    else:
        assert abs(st.niter - rst.niter) <= 1


MIXED_3D = (-1.0, 1.0, 1.0, -1.0, -1.0, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,signs,nsweeps,omega,dia", [
    # the 128^3 bench's projections (Neumann, 4 sweeps, omega 1.5) and
    # diffusion (the lid's walls, 1 sweep, dia = 1/(dt nu), dt = 0.8 h)
    ((128, 128, 128), (1.0,) * 6, 4, 1.5, 0.0),
    ((128, 128, 128), (-1.0,) * 6, 1, 1.0, 1.0 / (0.8 / 128 * 1e-3)),
    ((32, 32, 32), MIXED_3D, 4, 1.5, 0.0),
    ((64, 64, 64), MIXED_3D, 3, 1.3, 0.7),
    ((32, 64, 128), MIXED_3D, 4, 1.5, 0.0),
    ((5, 7, 9), MIXED_3D, 2, 1.0, 0.3),
])
def test_rbgs_relax_3d_kernel(dev, dtype, shape, signs, nsweeps, omega, dia):
    """K13 against its plain version: one call, 2 * nsweeps half-sweep
    launches, u left as it was."""
    from gerris_tpu_torch.ops.cuda import rbgs3d
    u, rhs = _rnd(dev, dtype, 30, shape, shape)
    u0 = u.clone()
    kw = dict(nsweeps=nsweeps, h2=1.0 / shape[0] ** 2, signs=signs,
              omega=omega)
    rbgs3d.reset_launch_counts()
    got = rbgs3d.rbgs_relax_3d(u, rhs, dia, **kw)
    assert rbgs3d.LAUNCHES == {"rbgs_relax_3d": 1,
                               "rbgs_relax_3d.half_sweep": 2 * nsweeps}
    assert torch.equal(u, u0)
    assert _rel(got, rbgs3d.rbgs_relax_3d_plain(u, rhs, dia, **kw)) \
        <= BOUND[dtype]


def test_rbgs_relax_3d_kernel_256(dev):
    """K13 at 256^3 in float32: no plane limit (the TPU kernel's was 128)."""
    from gerris_tpu_torch.ops.cuda import rbgs3d
    u, rhs = _rnd(dev, torch.float32, 31, (256,) * 3, (256,) * 3)
    kw = dict(nsweeps=4, h2=1.0 / 256 ** 2, signs=(1.0,) * 6, omega=1.5)
    assert _rel(rbgs3d.rbgs_relax_3d(u, rhs, 0.0, **kw),
                rbgs3d.rbgs_relax_3d_plain(u, rhs, 0.0, **kw)) <= 1e-5


def test_rbgs_relax_3d_kernel_zero_sweeps(dev):
    from gerris_tpu_torch.ops.cuda import rbgs3d
    u, rhs = _rnd(dev, torch.float64, 32, (8, 8, 8), (8, 8, 8))
    out = rbgs3d.rbgs_relax_3d(u, rhs, nsweeps=0, h2=0.1, signs=(1.0,) * 6)
    assert torch.equal(out, u) and out.data_ptr() != u.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_3d_step_kernels_match_plain(dev, dtype):
    """Three steps of the bench's 3D lid cavity at 32^3 on the card
    (dense 16^3, K13 at 32^3 only): 5 K13 calls per step, the same steps
    through the plain K13 to 1e-12 (float64) / 1e-4 (float32)."""
    import dataclasses
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.ops.cuda import rbgs3d
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    ub = bc.FieldBC.make(3, default=bc.Dirichlet(0.0), top=bc.Dirichlet(1.0))
    vb = bc.FieldBC.uniform(bc.Dirichlet(0.0), 3)
    proj = MultilevelParams(ncycles=1, omega=1.5)
    cfg = ns.NSConfig(grid=Grid(level=5, dim=3), u_bcs=(ub, vb, vb), nu=1e-3,
                      projection=proj, approx_projection=proj,
                      diffusion_params=dataclasses.replace(proj, nrelax=1,
                                                           omega=1.0))
    names = ("U", "V", "W", "P", "Pmac", "Gx", "Gy", "Gz")
    state = dict(zip(names, (0.1 * a for a in _rnd(
        dev, dtype, 33, *[(32, 32, 32)] * 8))))
    dt = 0.8 / 32

    def run():
        s = dict(state)
        for _ in range(3):
            s = ns.ns_step(s, dt, 0.0, cfg)
        return s

    rbgs3d.reset_launch_counts()
    got = run()
    assert rbgs3d.LAUNCHES["rbgs_relax_3d"] == 15
    k13 = rbgs3d.rbgs_relax_3d
    rbgs3d.rbgs_relax_3d = rbgs3d.rbgs_relax_3d_plain
    try:
        ref = run()
    finally:
        rbgs3d.rbgs_relax_3d = k13
    for k in ("U", "V", "W", "P"):
        assert _rel(got[k], ref[k]) <= (1e-12 if dtype == torch.float64
                                        else 1e-4), k


def test_rbgs_relax_3d_cuda_never_runs_plain(dev, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel: the plain version
    is never reached."""
    from gerris_tpu_torch.ops.cuda import rbgs3d

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(rbgs3d, "rbgs_relax_3d_plain", refuse)
    monkeypatch.setattr(rbgs3d, "rbgs3d_plain", refuse)
    u = torch.randn(16, 16, 16, device=dev)
    rbgs3d.reset_launch_counts()
    out = rbgs3d.rbgs_relax_3d(u, torch.randn_like(u), nsweeps=2, h2=0.01,
                               signs=(-1.0,) * 6)
    assert out.is_cuda
    assert rbgs3d.LAUNCHES == {"rbgs_relax_3d": 1,
                               "rbgs_relax_3d.half_sweep": 4}


# the fold route's pressure ghosts: the lid's (homogeneous Neumann),
# inhomogeneous Neumann, and Neumann rows with periodic columns
FOLD_GHOSTS = [((1.0,) * 4, (0.0,) * 4, False),
               ((1.0,) * 4, (-0.25 / 256, -0.5 / 256, 0.4 / 256, 0.75 / 256),
                False),
               ((1.0,) * 4, (-0.25 / 256, 0.0, 0.0, 0.0), True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("signs,offs,per_y", FOLD_GHOSTS)
def test_residual_restrict_div_kernel(dev, dtype, signs, offs, per_y):
    """K16 against its plain version (K4's divergence as K1's rhs), with a
    device-side sub and without."""
    n = 256
    u, ufx, ufy, sub = _rnd(dev, dtype, 31, (n, n), (n + 1, n), (n, n + 1),
                            (1,))
    kw = dict(h2=1.0 / n ** 2, signs=signs, offs=offs, per_y=per_y)
    for s in (0.0, sub):
        rbgs.reset_launch_counts()
        got = rbgs.residual_restrict_div(u, ufx, ufy, 0.3 / n ** 2, 0.0, s,
                                         **kw)
        assert rbgs.LAUNCHES["residual_restrict_div"] == 1
        ref = rbgs.residual_restrict_div_plain(u, ufx, ufy, 0.3 / n ** 2,
                                               0.0, s, **kw)
        for a, b in zip(got, ref):
            assert _rel(a, b) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_cells", [False, True])
@pytest.mark.parametrize("n", [256, 64])
@pytest.mark.parametrize("signs,offs,per_y", FOLD_GHOSTS)
def test_prolong_relax_correct_kernel(dev, dtype, with_cells, n, signs, offs,
                                      per_y):
    """K17 against its plain version (K3 + K5's correction), each output
    relative to its own max; tiled (256^2) and whole-level (64^2)."""
    c, rhs, u, ufx, ufy, U, V = _rnd(
        dev, dtype, 32, (n // 2, n // 2), (n, n), (n, n), (n + 1, n),
        (n, n + 1), (n, n), (n, n))
    cells = (U, V) if with_cells else None
    kw = dict(nsweeps=5, h2=1.0 / n ** 2, signs=signs, offs=offs,
              per_y=per_y, omega=1.5)
    rbgs.reset_launch_counts()
    got = rbgs.prolong_relax_correct(c, rhs, 0.0, u, ufx, ufy, 0.4 / n,
                                     1.0 / n, cells, **kw)
    assert rbgs.LAUNCHES["prolong_relax_correct"] == 1
    ref = rbgs.prolong_relax_correct_plain(c, rhs, 0.0, u, ufx, ufy, 0.4 / n,
                                           1.0 / n, cells, **kw)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a, b) <= BOUND[dtype]


@pytest.mark.parametrize("per_y", [False, True])
def test_prolong_relax_correct_tile_invariance(dev, per_y):
    """K17 bit-identical across tiles 32 and 16, and whole-level against
    tiled at 64^2."""
    signs, offs = (1.0,) * 4, (-0.001, 0.002, 0.0, 0.0)
    for n, kws in ((256, (dict(tile=32), dict(tile=16))),
                   (64, (dict(), dict(tile=16, whole_max=32)))):
        c, rhs, u, ufx, ufy, U, V = _rnd(
            dev, torch.float32, 33, (n // 2, n // 2), (n, n), (n, n),
            (n + 1, n), (n, n + 1), (n, n), (n, n))
        kw = dict(nsweeps=5, h2=1.0 / n ** 2, signs=signs, offs=offs,
                  per_y=per_y, omega=1.5)
        a, b = (rbgs.prolong_relax_correct(c, rhs, 0.0, u, ufx, ufy, 0.4 / n,
                                           1.0 / n, (U, V), **kw, **k)
                for k in kws)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), n


def test_fold_step_matches_unfolded_on_the_card(dev):
    """Three steps of the 64^2 lid cavity on the fold_correct route (K16,
    K2, K17 per projection) against the unfolded route, float64."""
    import dataclasses
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    proj = MultilevelParams(nrelax=5, omega=1.5, coarsest_relax=40,
                            ncycles=1)
    cfg = ns.NSConfig(grid=Grid(level=6), u_bcs=_velocity_bcs(False),
                      nu=1e-3, beta=1.0, projection=proj,
                      approx_projection=proj,
                      diffusion_params=dataclasses.replace(proj, nrelax=1,
                                                           omega=1.0),
                      pair_advect=True)
    fold = dataclasses.replace(proj, fold_div=True, fold_correct=True)
    folded = dataclasses.replace(cfg, projection=fold, approx_projection=fold)
    runs = {}
    for name, c in (("unfolded", cfg), ("fold", folded)):
        rbgs.reset_launch_counts()
        sim = Simulation(c, time=Time(dtmax=0.8 / 64), device=dev,
                         dtype=torch.float64).init()
        runs[name] = sim.run(max_steps=3).state
        if name == "fold":
            assert rbgs.LAUNCHES["residual_restrict_div"] == 7
            assert rbgs.LAUNCHES["prolong_relax_correct"] == 7
            assert rbgs.LAUNCHES["residual_restrict"] == 0
    for k in ("U", "V"):
        assert _rel(runs["fold"][k], runs["unfolded"][k]) <= 1e-9, k


# --- K15 rbgs_relax_alpha, the variable-coefficient smoother -------------------

ALPHA_CASES = {"walls": (SIGNS_LID, (False, False)),
               "per_x": ((1.0, 1.0, -1.0, 1.0), (True, False)),
               "per_xy": ((1.0, 1.0, 1.0, 1.0), (True, True))}


def _alpha_system(dev, dtype, seed, n, periodic, cell, dead):
    """u, rhs, positive face coefficients (face n = face 0 on a periodic
    axis), and a scalar or positive cell dia; ``dead``: a few cells with
    all four faces and dia zero."""
    u, rhs, ax, ay, d = _rnd(dev, dtype, seed, (n, n), (n, n), (n + 1, n),
                             (n, n + 1), (n, n))
    ax, ay = 0.2 + ax.abs(), 0.2 + ay.abs()
    dia = 0.5 + d.abs() if cell else 0.3
    if dead:
        for i, j in ((1, 2), (n // 2, n // 2 + 1), (n - 2, 3)):
            ax[i, j] = ax[i + 1, j] = ay[i, j] = ay[i, j + 1] = 0.0
            if cell:
                dia[i, j] = 0.0
        if not cell:
            dia = 0.0
    if periodic[0]:
        ax[n] = ax[0]
    if periodic[1]:
        ay[:, n] = ay[:, 0]
    return u, rhs, ax, ay, dia


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("kind", list(ALPHA_CASES))
def test_rbgs_relax_alpha_kernel(dev, dtype, kind, cell, dead):
    """K15 against its plain version at 256^2 (tiled), 8 sweeps, omega
    1.2: walls, periodic rows, doubly periodic; scalar and cell dia; with
    and without zero-diagonal cells, which keep their value."""
    n = 256
    signs, periodic = ALPHA_CASES[kind]
    u, rhs, ax, ay, dia = _alpha_system(dev, dtype, 40, n, periodic, cell,
                                        dead)
    kw = dict(nsweeps=8, h2=1.0 / n ** 2, signs=signs, periodic=periodic,
              omega=1.2, dia_cell=cell)
    rbgs.reset_launch_counts()
    got = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw)
    assert rbgs.LAUNCHES["rbgs_relax_alpha"] == 1
    assert _rel(got, rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, **kw)) \
        <= BOUND[dtype]
    if dead:
        assert got[1, 2] == u[1, 2] and got[n - 2, 3] == u[n - 2, 3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,nsweeps", [(128, 8), (64, 8), (32, 8), (16, 8),
                                       (8, 8), (4, 24)])
@pytest.mark.parametrize("kind", list(ALPHA_CASES))
def test_rbgs_relax_alpha_levels(dev, dtype, n, nsweeps, kind):
    """Every level size of a two-phase correction down to 4^2 (24 sweeps
    there, 8 * 1 + 16: the coarsest level's count), cell dia."""
    signs, periodic = ALPHA_CASES[kind]
    u, rhs, ax, ay, dia = _alpha_system(dev, dtype, 41, n, periodic, True,
                                        False)
    kw = dict(nsweeps=nsweeps, h2=1.0 / n ** 2, signs=signs,
              periodic=periodic, omega=1.0, dia_cell=True)
    got = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw)
    assert _rel(got, rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia, **kw)) \
        <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(ALPHA_CASES))
def test_rbgs_relax_alpha_tile_invariance(dev, dtype, kind):
    """Bit-identical across tiles 64 (float32), 32 and 16, whole-level and
    tiled, and one launch against several (sweeps split when their halo
    outgrows shared memory)."""
    signs, periodic = ALPHA_CASES[kind]
    u, rhs, ax, ay, dia = _alpha_system(dev, dtype, 42, 256, periodic, True,
                                        True)
    kw = dict(nsweeps=8, h2=1.0 / 256 ** 2, signs=signs, periodic=periodic,
              omega=1.5, dia_cell=True)
    ref = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, tile=16, **kw)
    tiles = (64, 32) if dtype == torch.float32 else (32,)
    for tile in tiles:
        assert torch.equal(ref, rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia,
                                                      tile=tile, **kw)), tile
    s = [t[:64, :64].contiguous() for t in (u, rhs, dia)]
    fx, fy = ax[:65, :64].contiguous(), ay[:64, :65].contiguous()
    if periodic[0]:
        fx[64] = fx[0]
    if periodic[1]:
        fy[:, 64] = fy[:, 0]
    whole = rbgs.rbgs_relax_alpha(s[0], s[1], fx, fy, s[2], **kw)
    assert torch.equal(whole, rbgs.rbgs_relax_alpha(
        s[0], s[1], fx, fy, s[2], tile=16, whole_max=32, **kw))
    kw["nsweeps"] = 30
    rbgs.reset_launch_counts()
    split = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, tile=32, **kw)
    assert rbgs.LAUNCHES["rbgs_relax_alpha"] > 1
    assert torch.equal(split, rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia,
                                                    tile=16, **kw))
    assert _rel(split, rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia,
                                                   **kw)) <= BOUND[dtype]


def test_twophase_step_on_the_card(dev):
    """Three two-phase steps at 64^2 in float64 on the card against the
    same steps on the CPU (the plain versions): K15 in every correction
    of the four solves per step, K6, K4, K14 and K9 around them."""
    import numpy as np
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import vof
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    tb = bc.default_scalar_bc(2)
    walls = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    proj = MultilevelParams(nrelax=8, coarsest_relax=16, tolerance=1e-3,
                            nitermax=100)
    cfg = ns.NSConfig(grid=Grid(level=6), u_bcs=(walls, walls), nu=1e-3,
                      vof_tracers=(("T", tb),), tension=(("T", 0.5),),
                      density=("T", 10.0, 1.0, 1), projection=proj,
                      approx_projection=proj,
                      diffusion_params=MultilevelParams(
                          nrelax=8, coarsest_relax=16, tolerance=1e-3,
                          nitermax=10))
    rng = np.random.default_rng(7)
    st = {k: torch.from_numpy(0.01 * rng.standard_normal((64, 64)))
          for k in ("U", "V", "P", "Pmac", "Gx", "Gy")}
    st["T"] = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: -(y - 0.01 * torch.cos(2 * torch.pi * x)),
        device="cpu")
    dt = 0.2 / 64
    runs = {}
    for where in ("cpu", dev):
        s = {k: v.to(where) for k, v in st.items()}
        rbgs.reset_launch_counts()
        for i in range(3):
            s = ns.ns_step(s, dt, 0.0, cfg, first_step=i == 0, cstart=i % 2)
        runs[str(where)] = s
        if where != "cpu":
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] > 0
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] % 5 == 0  # 64^2 .. 4^2
    for k in ("U", "V", "T"):
        assert _rel(runs[str(dev)][k].cpu(), runs["cpu"][k]) <= 1e-9, k
