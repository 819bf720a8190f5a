"""The block kernel's plain version against the cascade levels it replaces.

On the card every cascade (K2 ``cascade_prolong_relax``, K8b
``cascade_prolong_relax_pair``) runs its levels at and below 64^2 as one
launch of the block kernel, K12's ``coarse_block``; its plain version is
``coarse_tail_plain``.  Here, on the CPU in float64 and in torch only,
that plain tail is held bit for bit to the ladder of ``prolong_relax_plain``
calls the cascades ran level by level (the kernels' own bit-for-bit
checks against the K3 launches are in tests/test_torch_cuda.py), and the
wrappers' routes and input checks.  The plain cascades themselves are
held to the JAX kernels by tests/test_torch_rbgs.py and
tests/test_torch_pair.py, K12's block by tests/test_torch_coarse.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu_torch.ops.cuda import projops, rbgs  # noqa: E402

F64 = torch.float64


def _levels(seed, sizes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((m, m))) for m in sizes]


def _ladder(rs, dia, *, nsweeps, coarsest, h2, signs, per_y, omega):
    """The levels rs (finest first, h2 the finest's) level by level: K3's
    function from du = 0 at the coarsest, then prolong + relax."""
    n = rs[0].shape[0]
    du = rbgs.prolong_relax_plain(None, rs[-1], dia, nsweeps=coarsest,
                                  h2=h2 * (n // rs[-1].shape[0]) ** 2,
                                  signs=signs, per_y=per_y, omega=omega)
    for rk in reversed(rs[:-1]):
        du = rbgs.prolong_relax_plain(du, rk, dia, nsweeps=nsweeps,
                                      h2=h2 * (n // rk.shape[0]) ** 2,
                                      signs=signs, per_y=per_y, omega=omega)
    return du


CASES = [(1.0, 1), (1.0, 5), (1.5, 1), (1.5, 5)]


@pytest.mark.parametrize("omega,nsweeps", CASES)
@pytest.mark.parametrize("per_y", [False, True])
def test_tail_plain_is_the_ladder(omega, nsweeps, per_y):
    """64 -> 32 -> 16, 40 coarsest sweeps: the plain tail, alone and for a
    pair with two dias, bit for bit the ladder of prolong_relax_plain."""
    signs = (1.0, -1.0, 1.0, 1.0) if per_y else (-1.0, 1.0, -1.0, 1.0)
    kw = dict(nsweeps=nsweeps, coarsest=40, h2=1.0 / 64 ** 2, signs=signs,
              per_y=per_y, omega=omega)
    pair = [_levels(seed, (64, 32, 16)) for seed in (1, 2)]
    for rs, dia in zip(pair, (0.0, 2.5)):
        got = rbgs.coarse_tail_plain(rs, dia, **kw)
        assert got.dtype == F64 and got.shape == (64, 64)
        assert torch.equal(got, _ladder(rs, dia, **kw))


@pytest.mark.parametrize("omega,nsweeps", CASES)
@pytest.mark.parametrize("per_y", [False, True])
def test_cascade_plain_keeps_its_levels(omega, nsweeps, per_y):
    """The plain cascades, restructured around the tail: at n/2 = 64 the
    whole cascade is the tail of r1, r2 and r2's pool; at n/2 = 128 the
    tail's du at 64^2 goes up by prolong_relax_plain; single and as a
    pair (own dias), each bit for bit the level-by-level ladder."""
    signs = (1.0, 1.0, -1.0, -1.0) if per_y else (-1.0,) * 4
    for n_half in (64, 128):
        r1s = _levels(3 + n_half, (n_half, n_half))
        r2s = _levels(4 + n_half, (n_half // 2, n_half // 2))
        h2_half = 1.0 / n_half ** 2
        kw = dict(nsweeps=nsweeps, coarsest=40, h2_half=h2_half, signs=signs,
                  per_y=per_y, omega=omega)
        dias = [0.0, 1.5]
        pair = rbgs.cascade_prolong_relax_pair(r1s, r2s, dias, **kw)
        for b in range(2):
            levels = rbgs.pyramid_plain(r2s[b],
                                        (n_half // 2 // 16).bit_length() - 1)
            want = _ladder([r1s[b], r2s[b]] + levels, dias[b],
                           nsweeps=nsweeps, coarsest=40, h2=h2_half,
                           signs=signs, per_y=per_y, omega=omega)
            assert torch.equal(pair[b], want)
            assert torch.equal(rbgs.cascade_prolong_relax(
                r1s[b], r2s[b], dias[b], **kw), want)


@pytest.mark.parametrize("min_n", [2, 4, 16])
def test_coarse_block_plain_is_k12_ladder(min_n):
    """coarse_block and its pair on the CPU: coarse_vcycle_plain, which is
    the tail of r and its pools down to min(min_n, n), with omega."""
    r, r2 = _levels(5, (32, 32))
    kw = dict(nsweeps=5, coarsest=40, h2=1.0 / 32 ** 2,
              signs=(1.0,) * 4, min_n=min_n)
    for omega in (1.0, 1.5):
        want = [_ladder([x] + rbgs.pyramid_plain(x, (32 // min_n).bit_length()
                                                 - 1), d, nsweeps=5,
                        coarsest=40, h2=1.0 / 32 ** 2, signs=(1.0,) * 4,
                        per_y=False, omega=omega)
                for x, d in ((r, 0.0), (r2, 4.0))]
        assert torch.equal(rbgs.coarse_block(r, 0.0, omega=omega, **kw),
                           want[0])
        got = rbgs.coarse_block_pair([r, r2], [0.0, 4.0], omega=omega, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(rbgs.coarse_vcycle(r, 0.0, **kw),
                       rbgs.coarse_block(r, 0.0, **kw))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    r64, r128 = torch.zeros(64, 64, dtype=F64), torch.zeros(128, 128,
                                                           dtype=F64)
    kw = dict(nsweeps=1, coarsest=4, h2=1.0, signs=(1.0,) * 4)
    with pytest.raises(ValueError):
        rbgs.coarse_block(r128, **kw)
    with pytest.raises(ValueError):
        rbgs.coarse_block_pair([r128, r128], [0.0, 0.0], **kw)
    with pytest.raises(ValueError):
        rbgs.coarse_block_pair([r64], [0.0], **kw)
    with pytest.raises(ValueError):
        rbgs.coarse_block(r64, min_n=1, **kw)
    ckw = dict(nsweeps=1, coarsest=4, h2_half=1.0, signs=(1.0,) * 4)
    r2 = torch.zeros(32, 32, dtype=F64)
    for min_n in (1, 32):
        with pytest.raises(ValueError):
            rbgs.cascade_prolong_relax(r64, r2, min_n=min_n, **ckw)
        with pytest.raises(ValueError):
            rbgs.cascade_prolong_relax_pair([r64, r64], [r2, r2], [0.0, 0.0],
                                            min_n=min_n, **ckw)
    for warps in ((2, 2), (4, 32)):
        with pytest.raises(ValueError):
            rbgs.coarse_block(r64, warps=warps, **kw)
        with pytest.raises(ValueError):
            rbgs.coarse_block_pair([r64, r64], [0.0, 0.0], warps=warps, **kw)
    for warps in rbgs.CB_WARPS_SHAPES:
        assert torch.equal(rbgs.coarse_block(r64, warps=warps, **kw),
                           rbgs.coarse_vcycle_plain(r64, **kw))
    ufx, ufy = torch.zeros(9, 8, dtype=F64), torch.zeros(8, 9, dtype=F64)
    ufx[3, 2], ufy[1, 5] = 1.0, -2.0
    assert all(torch.equal(a, b) for a, b in zip(
        projops.divergence_mac(ufx, ufy, 0.1, 0.1),
        projops.divergence_mac_plain(ufx, ufy, 0.1, 0.1)))
