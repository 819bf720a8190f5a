"""The port's K6 predict_xy (plain version, CPU, float64) against the JAX
package's Pallas kernel run in interpret mode, as
tests/test_predict_kernel.py runs it, with strips of 32 rows at 128^2 so
that the kernel's strip seams are covered.  Tolerance: 1e-12 of max|ref|
for every output, and 1e-12 of sum|div| for the divergence's total."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import bcg as jbcg  # noqa: E402
from gerris_tpu.ops.pallas import predict as jpredict  # noqa: E402

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg as tbcg  # noqa: E402
from gerris_tpu_torch.ops.cuda import predict as tpredict  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

TOL = 1e-12
STRIP = 32


def velocity_bcs(kind):
    """(u_bc, v_bc) as JAX FieldBCs.  "lid": the cavity; "per_y": Dirichlet
    x walls with periodic y; "mixed": inhomogeneous Dirichlet normal faces
    with Neumann tangential sides."""
    if kind == "lid":
        return (jbc.FieldBC.make(2, default=jbc.Dirichlet(0.0),
                                 top=jbc.Dirichlet(1.0)),
                jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2))
    if kind == "per_y":
        per = (jbc.Periodic(), jbc.Periodic())
        return (jbc.FieldBC(((jbc.Dirichlet(0.5), jbc.Dirichlet(-0.25)), per)),
                jbc.FieldBC(((jbc.Dirichlet(0.1), jbc.Dirichlet(0.0)), per)))
    return (jbc.FieldBC(((jbc.Dirichlet(0.75), jbc.Dirichlet(0.5)),
                         (jbc.Neumann(), jbc.Neumann()))),
            jbc.FieldBC(((jbc.Neumann(), jbc.Dirichlet(0.2)),
                         (jbc.Dirichlet(-0.3), jbc.Dirichlet(0.4)))))


def specs(kind):
    """The JAX kernel specs of both components, checked equal to the
    port's kernel_spec of the carried-over BCs."""
    out = []
    for fbc in velocity_bcs(kind):
        js = jbcg.kernel_spec(fbc, with_face_bc=True)
        assert tbcg.kernel_spec(fieldbc_from_jax(fbc), with_face_bc=True) \
            == js
        out.append(js)
    return out


def rel(ref, got, scale=None):
    ref = np.asarray(ref)
    scale = np.max(np.abs(ref)) if scale is None else scale
    return float(np.max(np.abs(ref - got.numpy())) / scale)


@pytest.mark.parametrize("kind", ["lid", "per_y", "mixed"])
def test_predict_xy_matches_pallas(kind):
    su, sv = specs(kind)
    per_y = su["per_y"]
    u_bcs = [fieldbc_from_jax(b) for b in velocity_bcs(kind)]
    assert tbcg.face_specs(u_bcs) is not None
    grid = JGrid(level=7)
    rng = np.random.default_rng(11)
    U, V = rng.standard_normal((2,) + grid.shape)
    dt = 0.4 * grid.h
    scale = 1.0 / (grid.h * dt / 2.0)
    kw = dict(sgn_u=su["sgn"], off_u=su["off"], sgn_v=sv["sgn"],
              off_v=sv["off"], per_y=per_y, fb_x=su["fb_x"],
              fb_y=sv["fb_y"] or (0.0, 0.0))
    ref = jpredict.predict_xy(jnp.asarray(U), jnp.asarray(V), dt, grid.h,
                              S=STRIP, div_scale=scale, interpret=True, **kw)
    tU, tV = torch.from_numpy(U), torch.from_numpy(V)
    tgrid = TGrid(level=7)
    got = tpredict.predict_xy(tU, tV, dt, tgrid, u_bcs, div_scale=scale)
    for r, g in zip(ref[:3], got[:3]):
        assert r.shape == tuple(g.shape)
        assert rel(r, g) <= TOL
    assert rel(ref[3], got[3], np.sum(np.abs(np.asarray(ref[2])))) <= TOL
    # the faces without the divergence fold are the same faces
    faces = tpredict.predict_xy(tU, tV, dt, tgrid, u_bcs)
    assert faces[2:] == (None, None)
    assert all(torch.equal(a, b) for a, b in zip(faces[:2], got[:2]))
    if per_y:
        # face n1 is face 0
        assert torch.equal(got[1][:, 0], got[1][:, -1])
