"""Moving embedded solids at order 2 (gerris_tpu_torch/models/ns.py with
moving_order=2: the fill from the old fluid's neighbours, the
time-centred face fractions of the advection and the MAC projection on
them with the old cell fractions) against the JAX package on the CPU in
float64.

The step: chip_smoke.moving_cfg(4, 2), the disk of tests/test_torch_
moving.py at order 2, from its seeded velocity: the initial projection
and two ns_steps on both (the JAX steps eagerly, the only JAX step of
this file), every field within 1e-10 of max after each.  The
temporal-rate study of tests/test_moving.py (224 steps at 32^2, ~45 s on
the CPU) runs on the card in float64 (chip_smoke.moving_gate)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.models import ns as jns  # noqa: E402

import chip_smoke  # noqa: E402
import test_torch_moving  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.physics import solid  # noqa: E402

CPU = torch.device("cpu")


def test_moving2_step_matches_jax():
    test_torch_moving.compare_moving_step(2)


def _shifted_disk(t):
    def phi(x, y):
        return chip_smoke.moving_phi(x, y, t)
    return phi


def test_fill_order2_rings_and_fallback():
    """Order 2's fill: a cell uncovered since t takes the mean of its
    neighbours that held fluid at both times, a cell two rings deep the
    mean of the first ring's fills, one with no such neighbour within two
    rings the surface velocity; the solid takes the surface velocity; the
    rest keeps its value (the reference's ns.py:714-735 loop)."""
    n = 8
    a_old = torch.ones(n, n, dtype=torch.float64)
    a_old[2:6, 2:6] = 0.0                 # a solid block at t
    a = torch.ones(n, n, dtype=torch.float64)
    a[4:6, 4:6] = 0.0                     # mostly uncovered at t + dt
    u = torch.from_numpy(np.random.default_rng(5).standard_normal((n, n)))
    got = tns._fill_order2(u, a, a_old, 0.25)
    keep = (a > 0) & (a_old > 0)
    assert torch.equal(got[keep], u[keep])
    assert bool((got[a == 0.0] == 0.25).all())
    # (2, 2) touches (1, 2) and (2, 1): the mean of the two
    assert float(got[2, 2]) == float((u[1, 2] + u[2, 1]) / 2.0)
    # (3, 3) is two rings deep: the mean of its filled neighbours
    assert float(got[3, 3]) == float((got[2, 3] + got[3, 2]) / 2.0)
    # a 6 x 6 block uncovered at once: its middle is three rings deep
    a_old[1:7, 1:7] = 0.0
    got = tns._fill_order2(u, torch.ones(n, n, dtype=torch.float64), a_old,
                           0.25)
    assert bool((got[3:5, 3:5] == 0.25).all())
    assert bool((got[1:7, 1:7] != 0.25).sum() == 32)


def test_order2_weights_are_the_time_centred_fractions():
    """The order-2 weights: s_half = (s(t) + s(t + dt)) / 2, the old cell
    fractions for the MAC projection, the Dirichlet surface and merge
    table at t + dt; the fill and both divergence sources to the last bit
    of the JAX package's _moving_solid_ctx at level 5."""
    from test_torch_moving import moving_jcfg
    grid = Grid(5)
    cfg = chip_smoke.moving_cfg(5, 2)
    rng = np.random.default_rng(9)
    u, v = (rng.standard_normal(grid.shape) for _ in range(2))
    dt, t = 0.25 * grid.h, 0.03
    w, U, mac, apx = tns._moving_weights(
        cfg, [torch.from_numpy(u), torch.from_numpy(v)], dt, t)
    a0, s0 = solid.solid_fractions(grid, _shifted_disk(t), CPU)
    a1, s1 = solid.solid_fractions(grid, _shifted_disk(t + dt), CPU)
    assert torch.equal(w.a_old, a0) and torch.equal(w.a, a1)
    for c in range(2):
        assert torch.equal(w.s_half[c], 0.5 * (s0[c] + s1[c]))
    assert w.groups is not None and w.ds is not None
    jsol, jU, jmac, japx = jns._moving_solid_ctx(
        moving_jcfg(5, 2), [jnp.asarray(u), jnp.asarray(v)], dt, t)
    for ref, got in ((jU[0], U[0]), (jU[1], U[1]), (jmac, mac),
                     (japx, apx)):
        ref = np.asarray(ref)
        assert np.max(np.abs(ref - got.numpy())) <= 1e-13 * max(
            np.max(np.abs(ref)), 1.0)
