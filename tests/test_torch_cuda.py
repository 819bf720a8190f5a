"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips, with the reason, where torch has no CUDA
device (the CPU test run).  On a machine with a card:
    python -m pytest tests/test_torch_cuda.py -q
Tolerances: float64 1e-12 and float32 1e-5 (1e-4 for the cascade, whose
40 coarsest sweeps accumulate rounding) of max|plain|; tiled and
whole-level K3 launches are bit-identical.
"""
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402

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
