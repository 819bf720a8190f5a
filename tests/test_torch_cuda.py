"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips, with the reason, where torch has no CUDA
device (the CPU test run).  On a machine with a card:
    python -m pytest tests/test_torch_cuda.py -q
Tolerances: float64 1e-12 and float32 1e-5 (1e-4 for the cascade, whose
40 coarsest sweeps accumulate rounding) of max|plain|, and of sum|div| for
a divergence's total; tiled and whole-level K3 launches are
bit-identical, and so is K4's div across block shapes.  A kernel given
BCs outside its encoding raises.
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
