"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips, with the reason, where torch has no CUDA
device (the CPU test run).  On a machine with a card:
    python -m pytest tests/test_torch_cuda.py -q
Tolerances: float64 1e-12 and float32 1e-5 (1e-4 for the cascade, whose
40 coarsest sweeps accumulate rounding, as K12's do) of max|plain|, and
of sum|div| for a divergence's total; tiled and whole-level K3 and K10
launches are bit-identical, and so are K4's div across sum tiles (its
total bit for bit the two-pass sum's association, in one launch) and
K11's residual against K1's r0, K3, K8c and K17 across tiles, and the
restriction pyramid against the chain of restrict2 launches it
replaces; K6, K7 and K14 across their tile plans, K7 against two K14
launches, and K6's div against K4's on its faces.  A kernel given BCs
outside its encoding raises.  The adaptive solve on the card is held to
the same solve through the plain versions, and so are three steps of the
3D lid cavity (K13, the 3D smoother, at every level above the dense
one, one launch a level with the coarser level's correction prolonged in
it; bit-identical across its block decompositions, the fold held to
prolong + sweeps + add); K1, K8a and K16 at levels below and above
their tile and bit-identical across tile heights; three steps of the
fold route (K16, K2, K17 per projection) are held to the unfolded route.
K15, the variable-coefficient smoother, is held to its plain version on
every periodicity, dia mode and level size of a two-phase correction,
from a given u and with the coarse correction's prolongation folded in
(+ u), bit-identical across tiles, threads and sweep splits, and three
two-phase steps on the card to the same steps on the CPU.  K10 likewise
at 2048^2; K11 and K10 on the capillary wave's box levels, (1024, 3072)
down to (1, 3) and transposed, and three capillary-wave steps on the card
to the same steps on the CPU.  Slice 4b's routes (the moving disk at orders
1 and 2, the falling disk, the axisymmetric pipe, the stretched cavity)
run three steps on the card against the CPU, and the merge groups build
in two host syncs, bit for bit the CPU's.  The block kernel is held to its plain version at every level
count, omega, periodicity and batch, bit-identical across its launch
shapes, and each cascade's tail in it bit for bit the K3 launches it
replaces.
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
@pytest.mark.parametrize("n", [16, 32, 64, 512])
@pytest.mark.parametrize("per_y", [False, True])
def test_residual_restrict_tiles(dev, dtype, n, per_y):
    """K1, K8a and K16 against their plain versions at levels smaller
    and larger than the kernel's 32 x 128 tile, and bit-identical across
    its tile heights (8, 16, 32 rows); a u that is not 16-byte aligned
    takes the scalar loads and gives the same r0, r1, r2."""
    u, u2, rhs, rhs2, ufx, ufy, sub = _rnd(
        dev, dtype, 40, (n, n), (n, n), (n, n), (n, n), (n + 1, n),
        (n, n + 1), (1,))
    kw = dict(h2=1.0 / n ** 2, signs=SIGNS_LID, offs=OFFS_LID, per_y=per_y)
    kwp = dict(h2=1.0 / n ** 2, signs=SIGNS_LID, per_y=per_y,
               offss=[OFFS_LID, (0.0,) * 4])
    pair = ([u, u2], [rhs, rhs2], [0.6, 2.0], [sub, 0.0])
    calls = [
        (lambda **t: rbgs.residual_restrict(u, rhs, 0.6, sub, **kw, **t),
         rbgs.residual_restrict_plain(u, rhs, 0.6, sub, **kw)),
        (lambda **t: [x for xs in rbgs.residual_restrict_pair(
            *pair, **kwp, **t) for x in xs],
         [x for xs in rbgs.residual_restrict_pair_plain(*pair, **kwp)
          for x in xs]),
        (lambda **t: rbgs.residual_restrict_div(
            u, ufx, ufy, 0.3 / n ** 2, 0.0, sub, **kw, **t),
         rbgs.residual_restrict_div_plain(u, ufx, ufy, 0.3 / n ** 2, 0.0,
                                          sub, **kw))]
    for kern, ref in calls:
        got = kern()
        for a, b in zip(got, ref):
            assert _rel(a, b) <= BOUND[dtype]
        for rows in (8, 16):
            assert all(torch.equal(a, b)
                       for a, b in zip(got, kern(tile_rows=rows)))
    shifted = torch.empty(n * n + 1, device=dev, dtype=dtype)[1:].view(n, n)
    shifted.copy_(u)
    assert all(torch.equal(a, b) for a, b in zip(
        rbgs.residual_restrict(shifted, rhs, 0.6, sub, **kw),
        rbgs.residual_restrict(u, rhs, 0.6, sub, **kw)))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,coarse", [
    (1024, True), (512, True), (256, True), (128, True), (64, True),
    (32, True), (16, False)])
@pytest.mark.parametrize("per_y", [False, True])
def test_prolong_relax_every_cascade_level(dev, dtype, n, coarse, per_y):
    """K3 at every level of the main path's cascade, at the tile its plan
    picks for the card (64 at 1024^2, 32 at 512^2, 16 below, whole
    levels at 64^2 and under), 5 sweeps at omega 1.5, 40 from zero at
    16^2."""
    c, rhs = _rnd(dev, dtype, 40 + n, (n // 2, n // 2), (n, n))
    signs = (-1.0, -1.0, 1.0, 1.0) if per_y else SIGNS_LID
    kw = dict(nsweeps=5 if coarse else 40, h2=1.0 / n ** 2, signs=signs,
              per_y=per_y, omega=1.5)
    c = c if coarse else None
    got = rbgs.prolong_relax(c, rhs, 0.0, **kw)
    assert _rel(got, rbgs.prolong_relax_plain(c, rhs, 0.0, **kw)) \
        <= BOUND[dtype]


@pytest.mark.parametrize("per_y", [False, True])
def test_prolong_relax_tile_invariance(dev, per_y):
    c, rhs, u = _rnd(dev, torch.float32, 3, (128, 128), (256, 256),
                     (256, 256))
    kw = dict(nsweeps=5, h2=1.0 / 256 ** 2, signs=SIGNS_LID, omega=1.5,
              per_y=per_y)
    a = rbgs.prolong_relax(c, rhs, 0.0, u, tile=16, **kw)
    for tile in (32, 64, None):
        assert torch.equal(a, rbgs.prolong_relax(c, rhs, 0.0, u, tile=tile,
                                                 **kw))
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
    # 128 -> 64 -> 32 -> 16: one pyramid of three levels, then one block
    # launch for 16 (from zero), 32 and 64, then 128 and the n/2 level
    assert rbgs.LAUNCHES["cascade_prolong_relax"] == 1
    assert rbgs.LAUNCHES["cascade.restrict_pyramid"] == 1
    assert rbgs.LAUNCHES["restrict2"] == 0
    assert rbgs.LAUNCHES["cascade.coarse_block"] == 1
    assert rbgs.LAUNCHES["cascade.prolong_relax"] == 2
    assert rbgs.LAUNCHES["prolong_relax"] == 0
    assert rbgs.LAUNCHES["coarse_block"] == 0
    ref = rbgs.cascade_prolong_relax_plain(r1, r2, 0.0, **kw)
    bound = 1e-4 if dtype == torch.float32 else 1e-12
    assert _rel(got, ref) <= bound
    assert torch.equal(rbgs.restrict2(r1), rbgs.pool_plain(r1))


def _restrict2_chain(r, levels):
    out = []
    for _ in range(levels):
        r = rbgs.restrict2(r)
        out.append(r)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,levels", [(512, 5), (2048, 2), (1024, 8),
                                      (32, 5), (2, 1)])
def test_restrict_pyramid_kernel(dev, dtype, n, levels):
    """The pyramid bit-identical to the chain of restrict2 launches it
    replaces and to its plain version at every level, single and pair:
    the cascades' 512 -> 16, the adaptive correction's 2048 -> 512, the
    two-phase correction's 1024 -> 4 (past one cell per tile: the last
    block's tail), a one-block pyramid down to 1^2; and again, since the
    last block resets the arrival count for the next launch."""
    r, r2 = _rnd(dev, dtype, 41 + n, (n, n), (n, n))
    rbgs.reset_launch_counts()
    for _ in range(2):
        got = rbgs.restrict_pyramid(r, levels)
        pair = rbgs.restrict_pyramid_pair([r, r2], levels)
        assert [tuple(t.shape) for t in got] == \
            [(n >> k, n >> k) for k in range(1, levels + 1)]
        for want in (_restrict2_chain(r, levels),
                     rbgs.pyramid_plain(r, levels), pair[0]):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in
                   zip(pair[1], rbgs.pyramid_plain(r2, levels)))
    assert rbgs.LAUNCHES["restrict_pyramid"] == 2
    assert rbgs.LAUNCHES["restrict_pyramid_pair"] == 2
    assert rbgs.LAUNCHES["restrict2"] == 2 * levels


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
    # the same div and total in every run
    again = projops.divergence_mac(ufx, ufy, 0.01, grid.h)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _two_pass_total(div, bx, by):
    """The total of the two-pass sum that K4 replaced, in its association:
    a tree over each bx x by tile's flattened cells (cells outside the
    grid 0), then 1024 strided accumulators over the tiles' partials and
    their tree."""
    n0, n1 = div.shape
    ty, tx = -(-n0 // by), -(-n1 // bx)
    pad = div.new_zeros((ty * by, tx * bx))
    pad[:n0, :n1] = div
    red = pad.view(ty, by, tx, bx).permute(0, 2, 1, 3).reshape(ty * tx, -1)
    s = red.shape[1] // 2
    while s:
        red = red[:, :s] + red[:, s:2 * s]
        s //= 2
    parts = red[:, 0]
    acc = div.new_zeros(1024)
    for k in range(0, parts.numel(), 1024):
        chunk = parts[k:k + 1024]
        acc[:chunk.numel()] = acc[:chunk.numel()] + chunk
    while acc.numel() > 1:
        acc = acc[:acc.numel() // 2] + acc[acc.numel() // 2:]
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2048, 2048), (72, 100), (100, 72),
                                   (1, 1), (9, 130)])
def test_divergence_mac_one_launch(dev, dtype, shape):
    """K4 in one launch: div bit for bit its plain version's, total bit for
    bit the two-pass sum's association over BLOCK's tiles, twice (the
    last block resets the arrival count), and one device kernel per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n0, n1 = shape
    ufx, ufy = _rnd(dev, dtype, 71, (n0 + 1, n1), (n0, n1 + 1))
    ref = projops.divergence_mac_plain(ufx, ufy, 0.01, 1.0 / n1)
    for _ in range(2):
        div, total = projops.divergence_mac(ufx, ufy, 0.01, 1.0 / n1)
        assert torch.equal(div, ref[0])
        assert torch.equal(total, _two_pass_total(div, *projops.BLOCK))
    assert float((total - ref[1]).abs()) <= \
        BOUND[dtype] * float(ref[0].abs().sum())
    # the profiler at times records no device event of a short run (seen
    # on an H100): an empty trace shows nothing, so take the first of
    # three that holds any
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            projops.divergence_mac(ufx, ufy, 0.01, 1.0 / n1)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert [e.count for e in kernels] == [1]
    assert "divergence_mac_kernel" in kernels[0].key


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
    takes whole 32x8 tiles only (the ragged grid raises, below)."""
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


# --- K6 and the K7/K14 engine on their shared-memory tiles: a grid
# smaller than one tile (20 x 12) and one whose last block row and column
# are partial under every tile plan (52 x 84)
TILE_GRIDS = [Grid(level=1, extents=(10, 6)), Grid(level=2, extents=(13, 21))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_y", [False, True])
@pytest.mark.parametrize("grid", TILE_GRIDS)
def test_predict_xy_tiles(dev, dtype, per_y, grid):
    """K6 against its plain version on grids its tiles do not divide,
    periodic y included; faces and div bit-identical across the tile
    plans (the total sums in each plan's order), and the div
    bit-identical to K4's on the faces built."""
    U, V = _rnd(dev, dtype, 15, grid.shape, grid.shape)
    dt = 0.4 * grid.h
    u_bcs = _velocity_bcs(per_y)
    scale = 2.0 / (grid.h * dt)
    ref = predict.predict_xy_plain(U, V, dt, grid, u_bcs, scale)
    outs = [predict.predict_xy(U, V, dt, grid, u_bcs, scale, tile=t)
            for t in bcg.TILES]
    for got in outs:
        for a, b in zip(got[:2], ref[:2]):
            assert _rel(a, b) <= BOUND[dtype]
        _check_div(got[2:], ref[2:], dtype)
        assert all(torch.equal(a, b) for a, b in zip(got[:3], outs[0][:3]))
    k4 = projops.divergence_mac(outs[0][0], outs[0][1], dt / 2.0, grid.h)
    assert torch.equal(k4[0], outs[0][2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", TILE_GRIDS + GRIDS)
def test_advect_tiles(dev, dtype, grid):
    """K7 and K14 (g, gp, oscale) against their plain versions on grids
    their tiles do not divide, bit-identical across the tile plans, and K7
    bit-identical to two K14 launches (K14 is the one-component instance
    of K7's engine)."""
    n0, n1 = grid.shape
    v0, v1, ufx, ufy, g0, g1, gp0, gp1 = _rnd(
        dev, dtype, 16, grid.shape, grid.shape, (n0 + 1, n1), (n0, n1 + 1),
        *[grid.shape] * 4)
    fbcs = _velocity_bcs(False)
    dt = 0.3 * grid.h
    kw = dict(g=(g0, g1), gp=(gp0, gp1), oscale=-1.0 / (dt * 1e-3))
    ref = bcg.advect2d_pair_plain(v0, v1, ufx, ufy, dt, grid, fbcs, **kw)
    outs = [bcg.advect2d_pair(v0, v1, ufx, ufy, dt, grid, fbcs, tile=t, **kw)
            for t in bcg.TILES]
    for tile, got in zip(bcg.TILES, outs):
        _check_all(got, ref, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0]))
        k14 = [bcg.advect2d(v, c, ufx, ufy, dt, grid, fbcs[c], g=kw["g"][c],
                            gp=kw["gp"][c], oscale=kw["oscale"], tile=tile)
               for c, v in enumerate((v0, v1))]
        assert all(torch.equal(a, b) for a, b in zip(k14, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_advect2d_pair_rr_tiles(dev, dtype):
    """K7's rr_dia mode on a grid of whole 32x8 tiles that no tile plan
    divides (40 x 96): against its plain version, bit-identical across
    the tile plans."""
    grid = Grid(level=3, extents=(5, 12))
    n0, n1 = grid.shape
    v0, v1, ufx, ufy, g0, g1 = _rnd(dev, dtype, 17, grid.shape, grid.shape,
                                    (n0 + 1, n1), (n0, n1 + 1), grid.shape,
                                    grid.shape)
    fbcs = _velocity_bcs(False)
    dt = 0.3 * grid.h
    dia = 1.0 / (dt * 1e-3)
    kw = dict(g=(g0, g1), oscale=-dia, rr_dia=dia)
    ref = bcg.advect2d_pair_plain(v0, v1, ufx, ufy, dt, grid, fbcs, **kw)
    outs = [bcg.advect2d_pair(v0, v1, ufx, ufy, dt, grid, fbcs, tile=t, **kw)
            for t in bcg.TILES]
    for got in outs:
        _check_all(got, ref, dtype)
        assert all(torch.equal(a, b) for x, y in zip(got, outs[0])
                   for a, b in zip(x, y))


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
    # r2 64 -> 32 -> 16: one pair pyramid of two levels, then one block
    # launch for 16 (from zero), 32 and 64, then the n/2 = 128 level
    assert rbgs.LAUNCHES["residual_restrict_pair"] == 1
    assert rbgs.LAUNCHES["cascade_prolong_relax_pair"] == 1
    assert rbgs.LAUNCHES["cascade_pair.restrict_pyramid"] == 1
    assert rbgs.LAUNCHES["cascade_pair.coarse_block"] == 1
    assert rbgs.LAUNCHES["cascade_pair.prolong_relax"] == 1
    assert rbgs.LAUNCHES["prolong_relax_pair"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prolong_relax_pair_tile_invariance(dev, dtype):
    c0, c1, r0, r1, u0, u1 = _rnd(dev, dtype, 18, *[(128, 128)] * 2,
                                  *[(256, 256)] * 4)
    kw = dict(nsweeps=5, h2=1.0 / 256 ** 2, signs=SIGNS_LID, omega=1.5)
    a = rbgs.prolong_relax_pair([c0, c1], [r0, r1], [0.2, 0.4], [u0, u1],
                                tile=16, **kw)
    for tile in (32, 64, None):
        b = rbgs.prolong_relax_pair([c0, c1], [r0, r1], [0.2, 0.4],
                                    [u0, u1], tile=tile, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    c0, c1 = _rnd(dev, dtype, 42, (32, 32), (32, 32))
    r0, r1 = _rnd(dev, dtype, 43, (64, 64), (64, 64))
    kw["h2"] = 1.0 / 64 ** 2
    whole = rbgs.prolong_relax_pair([c0, c1], [r0, r1], [0.2, 0.4],
                                    [None, None], **kw)
    tiled = rbgs.prolong_relax_pair([c0, c1], [r0, r1], [0.2, 0.4],
                                    [None, None], tile=16, whole_max=32,
                                    **kw)
    assert all(torch.equal(x, y) for x, y in zip(whole, tiled))


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
    """K12 against its plain ladder: 1 + 1 + 3 launches at 512^2 (one
    pyramid down to 16^2, the block kernel for 64^2 .. 16^2), the pyramid
    and the block kernel at 128^2 and 64^2 (and K3 at 128^2), the block
    kernel alone at 16^2.  Its 40 coarsest sweeps accumulate float32
    rounding, as K2's do (1e-4)."""
    (r,) = _rnd(dev, dtype, 25, (n, n))
    signs = (-1.0, 1.0, 1.0, 1.0) if per_y else SIGNS_LID
    kw = dict(nsweeps=5, coarsest=40, h2=1.0 / n ** 2, signs=signs,
              per_y=per_y, min_n=16)
    rbgs.reset_launch_counts()
    got = rbgs.coarse_vcycle(r, 0.4, **kw)
    levels = {512: 3, 128: 1}.get(n, 0)
    assert rbgs.LAUNCHES["coarse_vcycle.restrict_pyramid"] == int(n > 16)
    assert rbgs.LAUNCHES["coarse_block"] == 1
    assert rbgs.LAUNCHES["coarse_vcycle.prolong_relax"] == levels
    bound = 1e-12 if dtype == torch.float64 else 1e-4
    assert _rel(got, rbgs.coarse_vcycle_plain(r, 0.4, **kw)) <= bound


# --- the block kernel: K12's, and every cascade's coarse tail


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("min_n", [2, 4, 8, 16])
@pytest.mark.parametrize("omega", [1.0, 1.5])
def test_coarse_block_kernel(dev, dtype, n, min_n, omega):
    """The block kernel alone and as a pair (two dias) against its plain
    version, periodic columns or not: its levels down to min(min_n, n)
    from one pyramid launch, 40 sweeps there, 5 per level above; the
    pair's systems each bit for bit its single launch."""
    r, r2 = _rnd(dev, dtype, 80 + n + min_n, (n, n), (n, n))
    bound = 1e-12 if dtype == torch.float64 else 1e-4
    for per_y in (False, True):
        signs = (1.0, -1.0, 1.0, 1.0) if per_y else (-1.0, 1.0, -1.0, 1.0)
        kw = dict(nsweeps=5, coarsest=40, h2=1.0 / n ** 2, signs=signs,
                  per_y=per_y, min_n=min_n, omega=omega)
        rbgs.reset_launch_counts()
        one = rbgs.coarse_block(r, 0.3, **kw)
        pair = rbgs.coarse_block_pair([r, r2], [0.3, 2.0], **kw)
        assert rbgs.LAUNCHES["coarse_block"] == 1
        assert rbgs.LAUNCHES["coarse_block_pair"] == 1
        pyramid = int(n > min_n)
        assert rbgs.LAUNCHES["coarse_block.restrict_pyramid"] == pyramid
        assert rbgs.LAUNCHES["coarse_block_pair.restrict_pyramid"] == pyramid
        assert torch.equal(pair[0], one)
        assert _rel(one, rbgs.coarse_vcycle_plain(r, 0.3, **kw)) <= bound
        assert _rel(pair[1], rbgs.coarse_vcycle_plain(r2, 2.0, **kw)) <= \
            bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coarse_block_launch_shapes(dev, dtype):
    """Bit-identical for every launch shape a test may ask for (warps at
    16^2 and below and at 32^2: the launch geometry only)."""
    r, r2 = _rnd(dev, dtype, 90, (64, 64), (64, 64))
    kw = dict(nsweeps=5, coarsest=40, h2=1.0 / 64 ** 2,
              signs=(-1.0, -1.0, 1.0, -1.0), omega=1.5, min_n=4)
    want = rbgs.coarse_block_pair([r, r2], [0.0, 1.0], **kw)
    for warps in rbgs.CB_WARPS_SHAPES:
        got = rbgs.coarse_block_pair([r, r2], [0.0, 1.0], warps=warps, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _cascade_by_k3(r1s, r2s, dias, *, nsweeps, coarsest, h2_half, signs,
                   per_y, omega, min_n):
    """A cascade as the K3 launches before the block kernel ran it: one
    pyramid, then K3 from zero at the coarsest level and prolong + relax
    at each level up to n/2, all through the public wrappers."""
    pair = len(r1s) == 2
    n_half = r1s[0].shape[0]
    m = min(min_n, n_half // 2)
    levels = (n_half // 2 // m).bit_length() - 1
    pyr = [[] for _ in r2s]
    if levels:
        pyr = (rbgs.restrict_pyramid_pair(r2s, levels) if pair
               else [rbgs.restrict_pyramid(r2s[0], levels)])
    lvs = [[r1, r2] + list(p) for r1, r2, p in zip(r1s, r2s, pyr)]
    kw = dict(signs=signs, per_y=per_y, omega=omega)
    du = [None] * len(r1s)
    for k in reversed(range(len(lvs[0]))):
        rk = [lv[k] for lv in lvs]
        h2 = h2_half * (n_half // rk[0].shape[0]) ** 2
        nsw = coarsest if du[0] is None else nsweeps
        du = (rbgs.prolong_relax_pair(du, rk, dias, [None, None],
                                      nsweeps=nsw, h2=h2, **kw) if pair
              else [rbgs.prolong_relax(du[0], rk[0], dias[0], nsweeps=nsw,
                                       h2=h2, **kw)])
    return du


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_half", [32, 64, 512])
@pytest.mark.parametrize("nsweeps,omega,min_n", [(5, 1.5, 16), (1, 1.0, 16),
                                                 (5, 1.5, 2), (2, 1.2, 4)])
@pytest.mark.parametrize("per_y", [False, True])
def test_cascade_tail_is_the_k3_launches(dev, dtype, n_half, nsweeps, omega,
                                         min_n, per_y):
    """K2 and K8b with their levels at and below 64^2 in one block launch,
    bit for bit the sequence of K3 launches they replace, single and pair
    (two dias); one block launch per cascade."""
    r1s = _rnd(dev, dtype, 95 + n_half, (n_half, n_half), (n_half, n_half))
    r2s = _rnd(dev, dtype, 96 + n_half, (n_half // 2, n_half // 2),
               (n_half // 2, n_half // 2))
    signs = (1.0, -1.0, 1.0, 1.0) if per_y else SIGNS_LID
    kw = dict(nsweeps=nsweeps, coarsest=40, h2_half=1.0 / n_half ** 2,
              signs=signs, per_y=per_y, omega=omega, min_n=min_n)
    dias = [0.0, 3.0]
    rbgs.reset_launch_counts()
    one = rbgs.cascade_prolong_relax(r1s[0], r2s[0], 0.7, **kw)
    pair = rbgs.cascade_prolong_relax_pair(r1s, r2s, dias, **kw)
    above = max(n_half // 64, 1).bit_length() - 1
    for route in ("cascade", "cascade_pair"):
        assert rbgs.LAUNCHES[f"{route}.coarse_block"] == 1
        assert rbgs.LAUNCHES[f"{route}.prolong_relax"] == above
    assert torch.equal(one, _cascade_by_k3([r1s[0]], [r2s[0]], [0.7],
                                           **kw)[0])
    assert all(torch.equal(a, b) for a, b in
               zip(pair, _cascade_by_k3(r1s, r2s, dias, **kw)))


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
    # one pyramid per cycle: the lid's 1024 -> 512 above K12, the
    # periodic system's 1024 -> 64 above the dense solve
    assert rbgs.LAUNCHES["restrict_pyramid"] == st.niter
    swaps = ("residual", "rbgs_relax", "coarse_vcycle", "prolong_relax",
             "restrict_pyramid")
    saved = {k: getattr(rbgs, k) for k in swaps}
    for k in swaps:
        setattr(rbgs, k, getattr(rbgs, k.replace("restrict_", "")
                                 + "_plain"))
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
    """K13 against its plain version: one call, one launch, u left as it
    was."""
    from gerris_tpu_torch.ops.cuda import rbgs3d
    u, rhs = _rnd(dev, dtype, 30, shape, shape)
    u0 = u.clone()
    kw = dict(nsweeps=nsweeps, h2=1.0 / shape[0] ** 2, signs=signs,
              omega=omega)
    rbgs3d.reset_launch_counts()
    got = rbgs3d.rbgs_relax_3d(u, rhs, dia, **kw)
    assert rbgs3d.LAUNCHES == {"rbgs_relax_3d": 1, "rbgs_relax_3d.launch": 1,
                               "rbgs_relax_3d.prolong": 0}
    assert torch.equal(u, u0)
    assert _rel(got, rbgs3d.rbgs_relax_3d_plain(u, rhs, dia, **kw)) \
        <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,signs,nsweeps,omega,dia", [
    ((128, 128, 128), (1.0,) * 6, 4, 1.5, 0.0),
    ((128, 128, 128), (-1.0,) * 6, 1, 1.0, 1.0 / (0.8 / 128 * 1e-3)),
    ((32, 32, 32), MIXED_3D, 4, 1.5, 0.0),
    ((64, 64, 64), MIXED_3D, 3, 1.3, 0.7),
    ((6, 10, 14), MIXED_3D, 2, 1.0, 0.3),
    ((8, 8, 8), MIXED_3D, 0, 1.5, 0.0),
])
def test_rbgs_relax_3d_fold_kernel(dev, dtype, shape, signs, nsweeps, omega,
                                   dia):
    """K13 from the prolongation of a coarse correction, with and without
    an added field, against its plain version (prolong3d_plain, the
    sweeps, the add): one launch each, counted as prolonged; the coarse
    correction and the added field left as they were."""
    from gerris_tpu_torch.ops.cuda import rbgs3d
    half = tuple(n // 2 for n in shape)
    c, rhs, add = _rnd(dev, dtype, 34, half, shape, shape)
    c0, add0 = c.clone(), add.clone()
    for a in (None, add):
        kw = dict(nsweeps=nsweeps, h2=1.0 / shape[0] ** 2, signs=signs,
                  omega=omega, coarse=c, add=a)
        rbgs3d.reset_launch_counts()
        got = rbgs3d.rbgs_relax_3d(None, rhs, dia, **kw)
        assert rbgs3d.LAUNCHES == {"rbgs_relax_3d": 1,
                                   "rbgs_relax_3d.launch": 1,
                                   "rbgs_relax_3d.prolong": 1}
        assert _rel(got, rbgs3d.rbgs_relax_3d_plain(None, rhs, dia, **kw)) \
            <= BOUND[dtype]
    assert torch.equal(c, c0) and torch.equal(add, add0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [16, 32, 64])
def test_rbgs_relax_3d_decompositions(dev, dtype, m):
    """K13 gives the plan's result bit for bit at 256 and 512 threads, one
    block, a few blocks and bricks of 1 x 1 to 8 x 16 rows (ragged at the
    level's edges); from u and from a coarse correction + u."""
    from gerris_tpu_torch.ops.cuda import rbgs3d
    c, rhs, add = _rnd(dev, dtype, 35, (m // 2,) * 3, (m,) * 3, (m,) * 3)
    kw = dict(nsweeps=3, h2=1.0 / m ** 2, signs=MIXED_3D, omega=1.5)
    variants = [dict(threads=t, blocks=b, brick=br)
                for t, b, br in ((256, None, None), (512, 1, None),
                                 (256, 5, (1, 1)), (512, None, (8, 16)),
                                 (256, 3, (3, 5)))]
    for first, args in ((add, kw), (None, dict(kw, coarse=c, add=add))):
        ref = rbgs3d.rbgs_relax_3d(first, rhs, 0.2, **args)
        for v in variants:
            assert torch.equal(ref, rbgs3d.rbgs_relax_3d(first, rhs, 0.2,
                                                         **args, **v)), v


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
    monkeypatch.setattr(rbgs3d, "prolong3d_plain", refuse)
    u = torch.randn(16, 16, 16, device=dev)
    rbgs3d.reset_launch_counts()
    out = rbgs3d.rbgs_relax_3d(u, torch.randn_like(u), nsweeps=2, h2=0.01,
                               signs=(-1.0,) * 6)
    assert out.is_cuda
    assert rbgs3d.LAUNCHES == {"rbgs_relax_3d": 1, "rbgs_relax_3d.launch": 1,
                               "rbgs_relax_3d.prolong": 0}
    out = rbgs3d.rbgs_relax_3d(None, u, nsweeps=2, h2=0.01,
                               signs=(-1.0,) * 6, coarse=u[:8, :8, :8]
                               .contiguous(), add=u)
    assert out.is_cuda
    assert rbgs3d.LAUNCHES == {"rbgs_relax_3d": 2, "rbgs_relax_3d.launch": 2,
                               "rbgs_relax_3d.prolong": 1}


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
    """K17 bit-identical across tiles 64, 32 and 16, and whole-level
    against tiled at 64^2."""
    signs, offs = (1.0,) * 4, (-0.001, 0.002, 0.0, 0.0)
    for n, kws in ((256, (dict(tile=16), dict(tile=32), dict(tile=64))),
                   (64, (dict(), dict(tile=16, whole_max=32)))):
        c, rhs, u, ufx, ufy, U, V = _rnd(
            dev, torch.float32, 33, (n // 2, n // 2), (n, n), (n, n),
            (n + 1, n), (n, n + 1), (n, n), (n, n))
        kw = dict(nsweeps=5, h2=1.0 / n ** 2, signs=signs, offs=offs,
                  per_y=per_y, omega=1.5)
        a, *others = (rbgs.prolong_relax_correct(
            c, rhs, 0.0, u, ufx, ufy, 0.4 / n, 1.0 / n, (U, V), **kw, **k)
            for k in kws)
        for b in others:
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("kind", list(ALPHA_CASES))
def test_rbgs_relax_alpha_fold_kernel(dev, dtype, kind, cell, dead):
    """K15 with a coarse correction prolonged at placement and u added,
    one launch, against its plain version (prolong_plain, the sweeps,
    + u) at 256^2, 8 sweeps, omega 1.2; and from zero without one."""
    n = 256
    signs, periodic = ALPHA_CASES[kind]
    u, rhs, ax, ay, dia = _alpha_system(dev, dtype, 43, n, periodic, cell,
                                        dead)
    c, = _rnd(dev, dtype, 44, (n // 2, n // 2))
    kw = dict(nsweeps=8, h2=1.0 / n ** 2, signs=signs, periodic=periodic,
              omega=1.2, dia_cell=cell)
    rbgs.reset_launch_counts()
    got = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, coarse=c, add=u,
                                **kw)
    assert rbgs.LAUNCHES["rbgs_relax_alpha"] == 1
    assert rbgs.LAUNCHES["rbgs_relax_alpha.prolong"] == 1
    assert _rel(got, rbgs.rbgs_relax_alpha_plain(
        None, rhs, ax, ay, dia, coarse=c, add=u, **kw)) <= BOUND[dtype]
    zero = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, **kw)
    assert rbgs.LAUNCHES["rbgs_relax_alpha.prolong"] == 1
    assert _rel(zero, rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dia,
                                                  **kw)) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1024, 512, 128, 64, 32, 16, 8, 4])
@pytest.mark.parametrize("kind", list(ALPHA_CASES))
def test_rbgs_relax_alpha_fold_levels(dev, dtype, n, kind):
    """Every level of a two-phase correction as the correction runs it:
    from zero with 24 sweeps at 4^2, the coarser level prolonged with 8
    sweeps above, + u at 1024^2; cell dia, the plan's tile."""
    signs, periodic = ALPHA_CASES[kind]
    u, rhs, ax, ay, dia = _alpha_system(dev, dtype, 45, n, periodic, True,
                                        False)
    c = None if n == 4 else _rnd(dev, dtype, 46, (n // 2, n // 2))[0]
    kw = dict(nsweeps=24 if n == 4 else 8, h2=1.0 / n ** 2, signs=signs,
              periodic=periodic, omega=1.0, dia_cell=True, coarse=c,
              add=u if n == 1024 else None)
    got = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, **kw)
    assert _rel(got, rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dia,
                                                 **kw)) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(ALPHA_CASES))
def test_rbgs_relax_alpha_fold_tile_invariance(dev, dtype, kind):
    """The fold bit-identical across tiles and threads, whole-level and
    tiled, and with its sweeps split over launches (the first prolongs,
    the last adds u)."""
    signs, periodic = ALPHA_CASES[kind]
    u, rhs, ax, ay, dia = _alpha_system(dev, dtype, 47, 256, periodic, True,
                                        True)
    c, = _rnd(dev, dtype, 48, (128, 128))
    kw = dict(nsweeps=8, h2=1.0 / 256 ** 2, signs=signs, periodic=periodic,
              omega=1.5, dia_cell=True, coarse=c, add=u)
    ref = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, tile=16, threads=256,
                                **kw)
    tiles = (64, 32, 16) if dtype == torch.float32 else (32, 16)
    for tile in tiles:
        for threads in (256, 512):
            assert torch.equal(ref, rbgs.rbgs_relax_alpha(
                None, rhs, ax, ay, dia, tile=tile, threads=threads, **kw)), \
                (tile, threads)
    s = [t[:64, :64].contiguous() for t in (rhs, dia)]
    fx, fy = ax[:65, :64].contiguous(), ay[:64, :65].contiguous()
    if periodic[0]:
        fx[64] = fx[0]
    if periodic[1]:
        fy[:, 64] = fy[:, 0]
    kw64 = dict(kw, coarse=c[:32, :32].contiguous(), add=None)
    assert torch.equal(
        rbgs.rbgs_relax_alpha(None, s[0], fx, fy, s[1], **kw64),
        rbgs.rbgs_relax_alpha(None, s[0], fx, fy, s[1], tile=16,
                              whole_max=32, **kw64))
    kw["nsweeps"] = 30
    rbgs.reset_launch_counts()
    split = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, tile=32, **kw)
    assert rbgs.LAUNCHES["rbgs_relax_alpha"] > 1
    assert rbgs.LAUNCHES["rbgs_relax_alpha.prolong"] == 1
    assert torch.equal(split, rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia,
                                                    tile=16, **kw))
    assert _rel(split, rbgs.rbgs_relax_alpha_plain(None, rhs, ax, ay, dia,
                                                   **kw)) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [(False, False), (True, False),
                                      (True, True)])
def test_rbgs_relax_kernel_2048(dev, dtype, periodic):
    """K10 at the adaptive_relax route's 2048^2 with its 4 sweeps:
    non-periodic, periodic rows, doubly periodic; bit-identical across
    tiles and threads."""
    n = 2048
    u, rhs = _rnd(dev, dtype, 49, (n, n), (n, n))
    kw = dict(nsweeps=4, h2=1.0 / n ** 2, signs=SIGNS_LID,
              periodic=periodic)
    rbgs.reset_launch_counts()
    got = rbgs.rbgs_relax(u, rhs, 0.4, **kw)
    assert rbgs.LAUNCHES["rbgs_relax"] == 1
    assert _rel(got, rbgs.rbgs_relax_plain(u, rhs, 0.4, **kw)) <= \
        BOUND[dtype]
    for tile in (64, 32, 16):
        for threads in (256, 512):
            assert torch.equal(got, rbgs.rbgs_relax(
                u, rhs, 0.4, tile=tile, threads=threads, **kw)), \
                (tile, threads)


def test_engine_kernels_never_run_plain(dev, monkeypatch):
    """A CUDA tensor given to K10 or K15 (from u, or with the fold)
    launches the kernel: their plain versions and the plain prolongation
    are never called."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("rbgs_relax_plain", "rbgs_relax_alpha_plain",
                 "prolong_plain", "rbgs_plain"):
        monkeypatch.setattr(rbgs, name, refuse)
    u, rhs, ax, ay, dia = _alpha_system(dev, torch.float32, 50, 128,
                                        (True, False), True, False)
    c, = _rnd(dev, torch.float32, 51, (64, 64))
    kw = dict(nsweeps=3, h2=1.0 / 128 ** 2, signs=(1.0, 1.0, -1.0, 1.0),
              periodic=(True, False), dia_cell=True)
    rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw)
    rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, coarse=c, add=u, **kw)
    rbgs.rbgs_relax(u, rhs, 0.2, nsweeps=3, h2=1.0 / 128 ** 2,
                    signs=(1.0,) * 4, periodic=(True, True))
    torch.cuda.synchronize()


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


# --- the boxes' levels (n, 2n), (n, 3n), (3n, n): K15 and the pyramid --------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,levels", [
    ((1024, 2048), 8), ((64, 128), 4), ((4, 8), 2),
    ((1024, 3072), 5), ((64, 192), 4),
    ((3072, 1024), 8), ((192, 64), 4), ((12, 4), 2)])
def test_restrict_pyramid_box_kernel(dev, dtype, shape, levels):
    """The pyramid on a box's level: the bubble's (n, 2n) (1024 x 2048 ->
    4 x 8), the capillary wave's (n, 3n) (1024 x 3072 -> 32 x 96) and the
    cylinder's (3n, n), the longer side first (3072 x 1024 -> 12 x 4):
    bit-identical at every level to the chain of restrict2 launches and to
    its plain version, single and pair, twice (the last block's tail
    resets the arrival count)."""
    n0, n1 = shape
    r, r2 = _rnd(dev, dtype, 60 + n0 + 7 * n1, shape, shape)
    for _ in range(2):
        got = rbgs.restrict_pyramid(r, levels)
        pair = rbgs.restrict_pyramid_pair([r, r2], levels)
        assert [tuple(t.shape) for t in got] == \
            [(n0 >> k, n1 >> k) for k in range(1, levels + 1)]
        for want in (_restrict2_chain(r, levels),
                     rbgs.pyramid_plain(r, levels), pair[0]):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in
                   zip(pair[1], rbgs.pyramid_plain(r2, levels)))


def _box_system(dev, dtype, seed, n0, n1, cell):
    """A K15 system on an n0 x n1 level with walls: u, rhs, positive face
    coefficients, a cell dia or the scalar 0, a few zero-diagonal
    cells."""
    u, rhs, ax, ay, d = _rnd(dev, dtype, seed, (n0, n1), (n0, n1),
                             (n0 + 1, n1), (n0, n1 + 1), (n0, n1))
    ax, ay = 0.2 + ax.abs(), 0.2 + ay.abs()
    dia = 0.5 + d.abs() if cell else 0.3
    for i, j in ((1, 2), (n0 // 2, n1 // 2 + 1), (n0 - 2, 3)):
        ax[i, j] = ax[i + 1, j] = ay[i, j] = ay[i, j + 1] = 0.0
        if cell:
            dia[i, j] = 0.0
    return u, rhs, ax, ay, dia if cell else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1024, 256, 64, 32, 16, 8, 4])
@pytest.mark.parametrize("cell", [False, True])
def test_rbgs_relax_alpha_box_kernel(dev, dtype, n, cell):
    """K15 on the bubble's (n, 2n) levels as its corrections run them:
    from zero with 24 sweeps at (4, 8), the coarser (n/2, n) level
    prolonged with 8 sweeps above, + u at the top (tiled above 64 cells a
    side, one whole-level block on its longer side's square buffer
    below); and from a given u; against the plain version."""
    u, rhs, ax, ay, dia = _box_system(dev, dtype, 61, n, 2 * n, cell)
    c = None if n == 4 else _rnd(dev, dtype, 62, (n // 2, n))[0]
    kw = dict(nsweeps=24 if n == 4 else 8, h2=1.0 / n ** 2,
              signs=(1.0, 1.0, -1.0, -1.0), periodic=(False, False),
              omega=1.0, dia_cell=cell)
    rbgs.reset_launch_counts()
    got = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, coarse=c, add=u,
                                **kw)
    assert rbgs.LAUNCHES["rbgs_relax_alpha"] == 1
    assert _rel(got, rbgs.rbgs_relax_alpha_plain(
        None, rhs, ax, ay, dia, coarse=c, add=u, **kw)) <= BOUND[dtype]
    from_u = rbgs.rbgs_relax_alpha(u, rhs, ax, ay, dia, **kw)
    assert _rel(from_u, rbgs.rbgs_relax_alpha_plain(u, rhs, ax, ay, dia,
                                                    **kw)) <= BOUND[dtype]
    assert from_u[1, 2] == u[1, 2]        # a zero-diagonal cell stays


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rbgs_relax_alpha_box_tile_invariance(dev, dtype):
    """On a box level K15 is bit-identical across its tiles and threads
    at (256, 512), and a whole (32, 64) level (one block on the square
    buffer of its longer side, the sweeps clipped to the domain) equals
    the same level tiled by 16."""
    u, rhs, ax, ay, dia = _box_system(dev, dtype, 63, 256, 512, True)
    c, = _rnd(dev, dtype, 64, (128, 256))
    kw = dict(nsweeps=8, h2=1.0 / 256 ** 2, signs=SIGNS_LID, omega=1.5,
              dia_cell=True, coarse=c, add=u)
    ref = rbgs.rbgs_relax_alpha(None, rhs, ax, ay, dia, tile=16, **kw)
    tiles = (64, 32) if dtype == torch.float32 else (32,)
    for tile in tiles:
        for threads in (256, 512):
            assert torch.equal(ref, rbgs.rbgs_relax_alpha(
                None, rhs, ax, ay, dia, tile=tile, threads=threads, **kw))
    w = _box_system(dev, dtype, 65, 32, 64, True)
    cw, = _rnd(dev, dtype, 66, (16, 32))
    for x, start in ((w[0], dict()), (None, dict(coarse=cw, add=w[0]))):
        kww = dict(kw, **start) if start else \
            {k: v for k, v in kw.items() if k not in ("coarse", "add")}
        assert torch.equal(
            rbgs.rbgs_relax_alpha(x, *w[1:], **kww),
            rbgs.rbgs_relax_alpha(x, *w[1:], tile=16, whole_max=32, **kww))


def test_bubble_step_on_the_card(dev):
    """Three steps of the rising bubble at level 5 (32 x 64) in float64 on
    the card against the same steps on the CPU (the plain versions): K15
    on the box's levels in every correction, the pyramid, K6, K4, K14
    and K9 around them; the variable viscosity and gravity in torch."""
    import numpy as np
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import vof
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    d0, nn = bc.Dirichlet(0.0), bc.Neumann()
    proj = MultilevelParams(nrelax=8, coarsest_relax=16, tolerance=1e-3,
                            nitermax=100)
    cfg = ns.NSConfig(
        grid=Grid(level=5, origin=(0.0, 0.0), extents=(1, 2)),
        u_bcs=(bc.FieldBC(((d0, d0), (d0, d0))),
               bc.FieldBC(((nn, nn), (d0, d0)))),
        vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension=(("T", 24.5),), density=("T", 1000.0, 100.0, 1),
        body_force=(None, -0.98),
        nu_var=lambda x, y, t=0.0, T1=None: 10.0 * T1 + (1.0 - T1),
        nu_var_fields=(("T1", "T", 1),), projection=proj,
        approx_projection=proj, diffusion_params=MultilevelParams(
            nrelax=8, coarsest_relax=16, tolerance=1e-3, nitermax=10))
    rng = np.random.default_rng(8)
    st = {k: torch.from_numpy(0.01 * rng.standard_normal((32, 64)))
          for k in ("U", "V", "P", "Pmac", "Gx", "Gy")}
    st["T"] = vof.fraction_from_levelset(
        cfg.grid, lambda x, y: torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
        - 0.25, device="cpu")
    dt = 0.2 / 32
    runs = {}
    for where in ("cpu", dev):
        s = {k: v.to(where) for k, v in st.items()}
        rbgs.reset_launch_counts()
        for i in range(3):
            s = ns.ns_step(s, dt, i * dt, cfg, first_step=i == 0,
                           cstart=i % 2)
        runs[str(where)] = s
        if where != "cpu":
            # levels (32, 64) .. (4, 8): four K15 launches a cycle
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] > 0
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] % 4 == 0
            assert rbgs.LAUNCHES["restrict_pyramid"] > 0
    for k in ("U", "V", "T"):
        assert _rel(runs[str(dev)][k].cpu(), runs["cpu"][k]) <= 1e-9, k


# --- slice 3c on the card: a tracer's K14, Navier and contact fields ------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", GRIDS)
def test_advect2d_tracer_kernel(dev, dtype, grid):
    """K14 on a passive tracer (c None): no gmac, no face forced, so a
    Dirichlet side's boundary faces keep their computed values, as the
    plain version's (and the reference's generic route's)."""
    n0, n1 = grid.shape
    v, ufx, ufy = _rnd(dev, dtype, 13, grid.shape, (n0 + 1, n1),
                       (n0, n1 + 1))
    fbc = bc.FieldBC.make(2, left=bc.Dirichlet(1.0), top=bc.Dirichlet(0.5))
    dt = 0.3 * grid.h
    bcg.reset_launch_counts()
    got = bcg.advect2d(v, None, ufx, ufy, dt, grid, fbc)
    assert bcg.LAUNCHES["advect2d"] == 1
    ref = bcg.advect2d_plain(v, None, ufx, ufy, dt, grid, fbc)
    assert _rel(got, ref) <= BOUND[dtype]


def test_navier_solve_takes_no_kernel(dev):
    """A Navier field's solve on the card runs the torch routes where a
    kernel would read its ghosts (its configuration refuses them): only
    the restriction pyramid, which reads none, launches; the result
    matches the CPU's."""
    from gerris_tpu_torch.solvers import poisson
    grid = Grid(level=7)
    fbc = bc.FieldBC.make(2, bottom=bc.Navier(0.05), top=bc.Navier(0.2),
                          left=bc.Dirichlet(0.0))
    u, rhs = _rnd(dev, torch.float64, 14, grid.shape, grid.shape)
    params = poisson.MultilevelParams(tolerance=1e-8, nitermax=50)
    rbgs.reset_launch_counts()
    got, st = poisson.solve(u, rhs, grid, fbc, params, dia=30.0)
    assert {k for k, v in rbgs.LAUNCHES.items() if v} == {"restrict_pyramid"}
    assert rbgs.LAUNCHES["restrict_pyramid"] == st.niter
    ref, sr = poisson.solve(u.cpu(), rhs.cpu(), grid, fbc, params, dia=30.0)
    assert st.niter == sr.niter
    assert _rel(got.cpu(), ref) <= 1e-12


@pytest.mark.parametrize("case", ["css", "sessile"])
def test_slice_3c_steps_on_the_card(dev, case):
    """Three steps at level 5 in float64 on the card against the CPU: the
    static droplet with the CSS tension under scheme "none" (the generic
    predictor and advection, K4, K5, K9 and the adaptive solves' kernels)
    and the sessile drop with a 60-degree contact angle (K6, K14 beside
    them)."""
    import math
    import numpy as np
    from gerris_tpu_torch.models import ns
    from gerris_tpu_torch.physics import vof
    from gerris_tpu_torch.solvers.advection import AdvectionParams
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    grid = Grid(level=5)
    walls = (bc.velocity_bc(0), bc.velocity_bc(1))
    if case == "css":
        mp = MultilevelParams(tolerance=1e-6, nitermax=100)
        cfg = ns.NSConfig(
            grid=grid, u_bcs=walls, nu=math.sqrt(0.8 / 12000), beta=1.0,
            advection=AdvectionParams(scheme="none"),
            vof_tracers=(("T", bc.default_scalar_bc(2)),),
            tension_css=(("T", 1.0),), projection=mp, approx_projection=mp,
            diffusion_params=MultilevelParams(tolerance=1e-6, nitermax=20))

        def phi(x, y):
            return 0.16 - ((x + 0.5) ** 2 + (y - 0.5) ** 2)
    else:
        cfg = ns.NSConfig(
            grid=grid, u_bcs=walls, nu=0.1, beta=1.0,
            vof_tracers=(("T", bc.FieldBC.make(2, bottom=bc.Contact(60.0))),),
            tension=(("T", 1.0),))

        def phi(x, y):
            return 0.09 - ((x + 0.5) ** 2 + (y + 0.5) ** 2)
    rng = np.random.default_rng(9)
    st = {k: torch.from_numpy(0.01 * rng.standard_normal((32, 32)))
          for k in ("U", "V", "P", "Pmac", "Gx", "Gy")}
    st["T"] = vof.fraction_from_levelset(grid, phi, device="cpu")
    dt = math.sqrt(grid.h ** 3 / math.pi)
    runs = {}
    for where in ("cpu", dev):
        s = {k: v.to(where) for k, v in st.items()}
        for mod in (rbgs, projops, predict, bcg):
            mod.reset_launch_counts()
        for i in range(3):
            s = ns.ns_step(s, dt, i * dt, cfg, first_step=i == 0,
                           cstart=i % 2)
        runs[str(where)] = s
        if where != "cpu":
            assert projops.LAUNCHES["divergence_mac"] == 6
            assert projops.LAUNCHES["interp_faces"] == 3
            assert rbgs.LAUNCHES["residual"] > 0
            assert predict.LAUNCHES["predict_xy"] == (0 if case == "css"
                                                      else 3)
            assert bcg.LAUNCHES["advect2d"] == (0 if case == "css" else 6)
    for k in ("U", "V", "T"):
        assert _rel(runs[str(dev)][k].cpu(), runs["cpu"][k]) <= 1e-9, k


# --- the capillary wave's box levels (n, 3n): K11 and K10 -------------------

BOX_SHAPES = [(1024, 3072), (512, 1536), (128, 384), (64, 192), (32, 96),
              (8, 24), (2, 6), (1, 3), (3072, 1024), (384, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", BOX_SHAPES)
def test_residual_rbgs_relax_box_kernels(dev, dtype, shape):
    """K11 and K10 on a box level (the longer side a multiple of the
    shorter, either one longer): periodic along the shorter side (the
    capillary wave's rows) and walls, against their plain versions; K10
    with 4 sweeps (12 on the coarsest boxes) in one launch."""
    n0, n1 = shape
    u, rhs = _rnd(dev, dtype, 70 + n0, shape, shape)
    per = (True, False) if n0 <= n1 else (False, True)
    h2 = (3.0 / max(shape)) ** 2
    for pr, sg, of in ((per, (1.0,) * 4, (0.0,) * 4),
                       ((False, False), (-1.0, 1.0, -1.0, 1.0),
                        (0.5, 0.0, -0.25, 0.0))):
        kw = dict(h2=h2, signs=sg, offs=of, periodic=pr)
        assert _rel(rbgs.residual(u, rhs, 2.0, **kw),
                    rbgs.residual_plain(u, rhs, 2.0, **kw)) <= BOUND[dtype]
        kw = dict(nsweeps=12 if min(shape) <= 2 else 4, h2=h2, signs=sg,
                  periodic=pr, omega=1.0 if pr[0] or pr[1] else 1.5)
        rbgs.reset_launch_counts()
        got = rbgs.rbgs_relax(u, rhs, 0.5, **kw)
        assert rbgs.LAUNCHES["rbgs_relax"] == 1
        assert _rel(got, rbgs.rbgs_relax_plain(u, rhs, 0.5, **kw)) <= \
            BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rbgs_relax_box_tile_invariance(dev, dtype):
    """K10 on a (256, 768) box level with periodic rows: bit-identical
    across its tiles and threads, and a whole (32, 96) level equals the
    same level tiled by 16 and 32."""
    u, rhs = _rnd(dev, dtype, 80, (256, 768), (256, 768))
    kw = dict(nsweeps=4, h2=1.0 / 256 ** 2, signs=(1.0, 1.0, -1.0, 1.0),
              periodic=(True, False))
    ref = rbgs.rbgs_relax(u, rhs, 0.0, tile=16, **kw)
    for tile in (64, 32):
        for threads in (256, 512):
            assert torch.equal(ref, rbgs.rbgs_relax(
                u, rhs, 0.0, tile=tile, threads=threads, **kw))
    w, wr = u[:32, :96].contiguous(), rhs[:32, :96].contiguous()
    whole = rbgs.rbgs_relax(w, wr, 0.0, whole_max=96, **kw)
    for tile in (32, 16):
        assert torch.equal(whole, rbgs.rbgs_relax(w, wr, 0.0, tile=tile,
                                                  **kw))


def test_capwave_steps_on_the_card(dev):
    """Three steps of the capillary wave at level 7 (128 x 384) in float64
    on the card against the same steps on the CPU (the plain versions):
    K11, the pyramid and K10 on the box's levels in every correction, K4
    per projection."""
    import chip_smoke
    runs = {}
    for where in (dev, torch.device("cpu")):
        rbgs.reset_launch_counts()
        s = chip_smoke.capwave_sim(where, 7, torch.float64)
        runs[str(where)] = s.run(max_steps=3).state
        if where.type == "cuda":
            assert rbgs.LAUNCHES["rbgs_relax"] > 0
            assert rbgs.LAUNCHES["rbgs_relax"] % 2 == 0  # (64, 192), (128, 384)
            assert rbgs.LAUNCHES["residual"] > 0
    for k in ("U", "V", "T", "P"):
        a, b = runs[str(dev)][k].cpu(), runs["cpu"][k]
        if k == "P":
            a, b = a - a.mean(), b - b.mean()
        assert _rel(a, b) <= 1e-9, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("system", ["projection", "viscous u", "viscous v"])
def test_rbgs_relax_alpha_cylinder_kernel(dev, dtype, system):
    """K15 on the cylinder's levels, (3072, 1024) down to (12, 4), with its
    geometry's coefficients (chip_smoke.cylinder_systems: the face
    fractions and dia 0 of the projections, beta dt nu s and the cell dia
    a + beta dt nu dia_s of the viscous solves) as a correction runs
    them, against the plain version; the solid's cells of zero diagonal
    keep their value."""
    import chip_smoke
    systems, ctx = chip_smoke.cylinder_systems(dev, dtype)
    _, signs, alphas, dias, grids = [x for x in systems if x[0] == system][0]
    nl = len(grids)
    for k in range(nl):
        shape = grids[k].shape
        rhs, u = _rnd(dev, dtype, 90 + k, shape, shape)
        c = None if k == nl - 1 else _rnd(dev, dtype, 99, grids[k + 1].shape)[0]
        kw = dict(nsweeps=12 if c is None else 4, h2=grids[k].h ** 2,
                  signs=signs, periodic=(False, False),
                  dia_cell=not isinstance(dias[k], float))
        args = (rhs, *alphas[k], dias[k])
        fold = dict(kw, coarse=c, add=u if k == 0 else None)
        assert _rel(rbgs.rbgs_relax_alpha(None, *args, **fold),
                    rbgs.rbgs_relax_alpha_plain(None, *args, **fold)) \
            <= BOUND[dtype], shape
        if k == 0:
            got = rbgs.rbgs_relax_alpha(u, *args, **kw)
            assert _rel(got, rbgs.rbgs_relax_alpha_plain(u, *args, **kw)) \
                <= BOUND[dtype]
            dead = ctx.a == 0.0
            assert bool(dead.any()) and torch.equal(got[dead], u[dead])


def test_cylinder_steps_on_the_card(dev):
    """Init and three steps of the flow past a cylinder at level 5 (96 x
    32) in float64 on the card against the same steps on the CPU (the
    plain versions): K15 and the pyramid in every solve's correction, no
    other kernel."""
    import chip_smoke
    runs = {}
    for where in (dev, torch.device("cpu")):
        rbgs.reset_launch_counts()
        projops.reset_launch_counts()
        predict.reset_launch_counts()
        s = chip_smoke.cylinder_sim(where, 5, torch.float64)
        runs[str(where)] = s.run(max_steps=3).state
        if where.type == "cuda":
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] > 0
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] % 4 == 0  # 4 levels
            assert rbgs.LAUNCHES["restrict_pyramid"] > 0
            assert predict.LAUNCHES["predict_xy"] == 0
            assert projops.LAUNCHES["interp_faces"] == 0
    for k in ("U", "V", "P"):
        assert _rel(runs[str(dev)][k].cpu(), runs["cpu"][k]) <= 1e-9, k


# --- slice 4b on the card: moving solids, rigid bodies, the metrics -------

@pytest.mark.parametrize("case", ["moving1", "moving2", "rigid", "axi",
                                  "stretch"])
def test_slice_4b_steps_on_the_card(dev, case):
    """Three steps of each slice 4b route at level 5 in float64 on the card
    against the same steps on the CPU (the plain versions): K15 and the
    pyramid in every solve's correction (K6 and K9 where the walls admit
    them); a moving solid's merge groups rebuilt every step on the card.
    The axisymmetric pipe's V and P, 0 up to the solves' tolerance, are
    held relative to max|U|, as chip_smoke's axi phase holds them."""
    import chip_smoke
    make = {"moving1": lambda w: chip_smoke.moving_sim(w, 1, 5,
                                                       torch.float64),
            "moving2": lambda w: chip_smoke.moving_sim(w, 2, 5,
                                                       torch.float64),
            "rigid": lambda w: chip_smoke.rigid_run(w, 5, torch.float64),
            "axi": lambda w: chip_smoke.axi_sim(w, 5, torch.float64),
            "stretch": lambda w: chip_smoke.stretch_sim(w, 5,
                                                        torch.float64)}[case]
    runs = {}
    for where in (dev, torch.device("cpu")):
        rbgs.reset_launch_counts()
        runs[where.type] = make(where).run(max_steps=3).state
        if where.type == "cuda":
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] > 0
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] % 4 == 0  # 4 levels
            assert rbgs.LAUNCHES["restrict_pyramid"] > 0
    for k in ("U", "V", "P"):
        got, ref = runs["cuda"][k].cpu(), runs["cpu"][k]
        if case == "axi" and k != "U":
            err = float((got - ref).abs().max()
                        / runs["cpu"]["U"].abs().max())
        else:
            err = _rel(got, ref)
        assert err <= 1e-9, k


@pytest.mark.parametrize("level", [7, 10])
def test_merge_groups_on_the_card(dev, level):
    """merge_groups on the card: two host syncs (torch.cuda's sync debug
    mode), the groups and merged_cell_update bit for bit those of the
    CPU on the cylinder's geometry, and the same bits on a second
    build."""
    import chip_smoke
    from gerris_tpu_torch.physics import solid
    g = Grid(level, extents=(3, 1))
    a, s = solid.solid_fractions(g, chip_smoke.cylinder_phi, dev,
                                 torch.float64)
    torch.cuda.synchronize()
    n, groups = chip_smoke.count_syncs(lambda: solid.merge_groups(a, s), dev)
    assert n == 2
    ca, cs = a.cpu(), tuple(f.cpu() for f in s)
    ref = solid.merge_groups(ca, cs)
    for k in ("members", "index", "group"):
        assert torch.equal(getattr(groups, k).cpu(), getattr(ref, k)), k
    v, fv = _rnd(dev, torch.float64, 7, g.shape, g.shape)
    got = solid.merged_cell_update(v, fv, a, s, groups)
    assert torch.equal(got, solid.merged_cell_update(
        v, fv, a, s, solid.merge_groups(a, s)))
    assert torch.equal(got.cpu(), solid.merged_cell_update(
        v.cpu(), fv.cpu(), ca, cs, ref))


@pytest.mark.parametrize("route", ["amr_osc", "amr_capwave"])
def test_amr_steps_on_the_card(dev, route):
    """Init + 3 steps of an AMR route at maxlevel 6 in float64 on the card
    against the same steps on the CPU (the plain versions): the block
    engine's base corrections (K15, the pyramid), K6 and K9 per level
    (amr_osc); K11 and K10 on every box level (amr_capwave); the leaves
    equal."""
    import warnings
    import chip_smoke
    from gerris_tpu_torch.ops.cuda import predict, projops
    runs = {}
    for where in (dev, torch.device("cpu")):
        for mod in (rbgs, predict, projops):
            mod.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            s = chip_smoke.AMR_ROUTES[route](where, 6, torch.float64)
            s.run(max_steps=3)
        runs[str(where)] = s
        if where.type == "cuda" and route == "amr_osc":
            assert s._use_blocks
            assert rbgs.LAUNCHES["rbgs_relax_alpha"] > 0
            assert predict.LAUNCHES["predict_xy"] == 3 * 4
            assert projops.LAUNCHES["interp_faces"] == 4 * 4
        elif where.type == "cuda":
            assert rbgs.LAUNCHES["residual"] > 0
            assert rbgs.LAUNCHES["rbgs_relax"] > 0
    a, b = runs[str(dev)], runs["cpu"]
    assert a.leaf_history == b.leaf_history
    for k in ("U", "V", "T", "P"):
        x, y = a.fine(k).cpu(), b.fine(k)
        if k == "P":
            x, y = x - x.mean(), y - y.mean()
        assert _rel(x, y) <= 1e-9, k


def _particle_case(dev, dtype, n=4096, cap=4608):
    """Seeded fields and particles at 128^2 of ``dtype`` on the card, n
    particles in a box a little larger than the grid's, and the same
    values in float64 on the CPU: (card, cpu), each (U, particles,
    values)."""
    from gerris_tpu_torch.physics import particles
    g = torch.Generator().manual_seed(6)
    U = [torch.randn((128, 128), generator=g).to(dtype) for _ in range(2)]
    pos = (1.04 * torch.rand((n, 2), generator=g) - 0.52).to(dtype)
    vals = torch.randn(cap, generator=g).to(dtype)
    out = []
    for where, dt in ((dev, dtype), (torch.device("cpu"), torch.float64)):
        out.append(([u.to(where, dt) for u in U],
                    particles.make_particles(cap, 2, pos=pos.to(dt),
                                             device=where, dtype=dt),
                    vals.to(where, dt)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_particle_gather_on_the_card(dev, dtype):
    """The particles' gather (the lid's BC ghosts, all 2^2 corners in one
    indexing) on the card against the CPU in float64."""
    from gerris_tpu_torch.physics import particles
    grid = Grid(7)
    (got_u, got_p, _), (ref_u, ref_p, _) = _particle_case(dev, dtype)
    ubc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0), top=bc.Dirichlet(1.0))
    got = particles.interpolate_at(got_u[0], grid, ubc, got_p["pos"])
    ref = particles.interpolate_at(ref_u[0], grid, ubc, ref_p["pos"])
    assert _rel(got.cpu().double(), ref) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rkernel", [0.0, 1.0])
def test_particle_deposit_on_the_card(dev, dtype, rkernel):
    """Both deposits (bilinear; the Gaussian of radius h over 7^2 cells),
    one index_add_ each, on the card against the CPU in float64 (the
    card's float atomics sum in any order: within the bound, not bit for
    bit)."""
    from gerris_tpu_torch.physics import particles
    grid = Grid(7)
    cfg = particles.ParticleConfig(4608, rkernel=rkernel * grid.h)
    (_, got_p, got_v), (_, ref_p, ref_v) = _particle_case(dev, dtype)
    got = particles.deposit(got_v, got_p, grid, cfg)
    ref = particles.deposit(ref_v, ref_p, grid, cfg)
    assert _rel(got.cpu().double(), ref) <= BOUND[dtype]


# --- slice 7 on the card: the .gfs reader, the CLI, GfsPoisson --------------

def test_gfs_lid_cli_is_the_hand_built_run_on_the_card(dev, tmp_path):
    """The lid's .gfs text at 64^2 in float32 through the CLI's entry point
    and by hand from chip_smoke.gfs_lid_cfg on the card: bit-identical,
    with equal launches per kernel; held to the plain versions on the
    card (chip_smoke's gfs phase at 2048^2 does the same)."""
    import chip_smoke
    path = tmp_path / "lid.gfs"
    path.write_text(chip_smoke.GFS_LID)
    runs = chip_smoke.gfs_lid_runs(str(path), 6, 0.8 / 64, 3,
                                   str(tmp_path / "end.gfs"), dev,
                                   torch.float32, counted=True)
    assert runs["counts_cli"] == runs["counts_hand"]
    assert runs["counts_cli"]["residual"] > 0
    for k in ("U", "V", "P"):
        assert torch.equal(runs["cli"][k], runs["hand"][k]), k
    assert runs["rows_cli"] == runs["rows_hand"]
    ref = chip_smoke.gfs_resume(str(tmp_path / "end.gfs"), dev,
                                torch.float32)
    for k in ("U", "V", "P"):
        assert torch.equal(ref.state[k], runs["cli"][k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gfs_poisson_on_the_card(dev, dtype):
    """GfsPoisson's .gfs text at 128^2 on the card against the same solve
    on the CPU (mean-free), its error norms the CPU's."""
    import chip_smoke
    got = chip_smoke.gfs_build(chip_smoke.GFS_POISSON, dev, dtype,
                               LEVEL=7).run()
    ref = chip_smoke.gfs_build(chip_smoke.GFS_POISSON, "cpu",
                               torch.float64, LEVEL=7).run()
    a = got.state["P"].cpu().double()
    b = ref.state["P"]
    assert _rel(a - a.mean(), b - b.mean()) <= \
        (1e-10 if dtype == torch.float64 else 1e-4)
    nr = chip_smoke.gfs_poisson_norms(ref)
    assert abs(chip_smoke.gfs_poisson_norms(got) / nr - 1).max() <= \
        (1e-9 if dtype == torch.float64 else 1e-2)


def test_gfs_advection_on_the_card(dev):
    """GfsAdvection's .gfs text at 64^2 on the card against the CPU."""
    import chip_smoke
    got = chip_smoke.gfs_build(chip_smoke.GFS_ADVECTION, dev, torch.float64,
                               LEVEL=6).run()
    ref = chip_smoke.gfs_build(chip_smoke.GFS_ADVECTION, "cpu",
                               torch.float64, LEVEL=6).run()
    assert got.i == ref.i
    for k in ("T", "C"):
        assert _rel(got.state[k].cpu(), ref.state[k]) <= 1e-10, k
