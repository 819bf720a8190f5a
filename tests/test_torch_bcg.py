"""The port's K14 advect2d (plain version, CPU, float64) against the JAX
package's Pallas kernel run in interpret mode, as tests/test_bcg_kernel.py
runs it, with strips of 32 rows at 128^2 so that the kernel's strip seams
are covered.  Every cell is compared, the corner cells included: the
port's torch route pads its ghosts in the kernels' order.  Tolerance:
1e-12 of max|ref|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import bcg as jbcg  # noqa: E402

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg as tbcg  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

from test_torch_predict import rel, velocity_bcs  # noqa: E402

TOL = 1e-12
STRIP = 32
LEVEL = 7


def fields(seed):
    n = 1 << LEVEL
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)), rng.standard_normal((n + 1, n)),
            rng.standard_normal((n, n + 1)), rng.standard_normal((n, n)),
            rng.standard_normal((n, n)))


@pytest.mark.parametrize("folds", [False, True])
@pytest.mark.parametrize("c", [0, 1])
@pytest.mark.parametrize("kind", ["lid", "mixed"])
def test_advect2d_matches_pallas(kind, c, folds):
    """Component ``c`` of the velocity BCs ``kind`` (test_torch_predict),
    with the gmac correction g; ``folds``: also the gp and oscale folds of
    the diffusion rhs."""
    fbc = velocity_bcs(kind)[c]
    spec = jbcg.kernel_spec(fbc, with_face_bc=True)
    tfbc = fieldbc_from_jax(fbc)
    assert tbcg.advect_spec(tfbc) == spec
    grid = JGrid(level=LEVEL)
    v, ufx, ufy, g, gp = fields(20 + c)
    dt = 0.35 * grid.h
    osc = -1.0 / (dt * 1e-3) if folds else None
    ref = jbcg.advect2d(
        jnp.asarray(v), jnp.asarray(ufx), jnp.asarray(ufy), jnp.asarray(dt),
        grid.h, jnp.asarray(g), gp=jnp.asarray(gp) if folds else None,
        oscale=None if osc is None else jnp.asarray(osc), sgn=spec["sgn"],
        off=spec["off"], per_y=False,
        fb_x=spec["fb_x"] if c == 0 else None,
        fb_y=spec["fb_y"] if c == 1 else None, S=STRIP, interpret=True)
    T = [torch.from_numpy(a) for a in (v, ufx, ufy, g, gp)]
    got = tbcg.advect2d(T[0], c, T[1], T[2], dt, TGrid(level=LEVEL), tfbc,
                        g=T[3], gp=T[4] if folds else None, oscale=osc)
    assert ref.shape == tuple(got.shape)
    assert rel(ref, got) <= TOL


def test_advect_spec_refuses_periodic_y():
    """K14 refuses periodic y (its gmac ghosts are edge values) and the
    encodings kernel_spec refuses; K6/K9 take periodic y."""
    per = (jbc.Periodic(), jbc.Periodic())
    fbc = fieldbc_from_jax(jbc.FieldBC(((jbc.Dirichlet(0.5),
                                         jbc.Dirichlet(0.0)), per)))
    assert tbcg.kernel_spec(fbc, with_face_bc=True)["per_y"]
    assert tbcg.advect_spec(fbc) is None
    rows = fieldbc_from_jax(jbc.FieldBC((per, per)))
    assert tbcg.advect_spec(rows) is None


def test_tile_plan():
    """K6's and the K7/K14 engine's tile: the first the kernels are built
    for, or one of them given by a test; any other raises."""
    assert tbcg.tile_plan() == tbcg.TILES[0]
    for tile in tbcg.TILES:
        assert tbcg.tile_plan(list(tile)) == tile
    with pytest.raises(ValueError, match="want one of"):
        tbcg.tile_plan((8, 8))
