"""The port's projection kernels K4 divergence_mac, K5 correct_project and
K9 interp_faces (plain versions, CPU, float64) against the JAX package's
Pallas kernels run in interpret mode, as tests/test_projops_kernel.py runs
them, with strips of 32 rows at 128^2 so that the kernels' strip seams
are covered.  Tolerance: 1e-12 of max|ref| for every output, and 1e-12 of
sum|div| for a divergence's total."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.ops.pallas import bcg as jbcg  # noqa: E402
from gerris_tpu.ops.pallas import projops as jprojops  # noqa: E402

from gerris_tpu_torch.core.grid import Grid as TGrid  # noqa: E402
from gerris_tpu_torch.ops.cuda import bcg as tbcg  # noqa: E402
from gerris_tpu_torch.ops.cuda import projops as tprojops  # noqa: E402
from gerris_tpu_torch.utils.convert import fieldbc_from_jax  # noqa: E402

from test_torch_predict import rel, specs, velocity_bcs  # noqa: E402

TOL = 1e-12
STRIP = 32
GRID = JGrid(level=7)
TGRID = TGrid(level=7)


def fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def check_outputs(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert np.asarray(r).shape == tuple(g.shape)
        assert rel(r, g) <= TOL


def check_total(ref_div, ref_total, got_total):
    assert got_total.shape == (1,)
    scale = np.sum(np.abs(np.asarray(ref_div)))
    assert abs(float(ref_total) - float(got_total)) <= TOL * scale


def test_divergence_mac_matches_pallas():
    n0, n1 = GRID.shape
    ufx, ufy = fields(1, (n0 + 1, n1), (n0, n1 + 1))
    dt = 0.37 * GRID.h
    div, total = jprojops.divergence_mac(jnp.asarray(ufx), jnp.asarray(ufy),
                                         dt, GRID.h, S=STRIP, interpret=True)
    gdiv, gtotal = tprojops.divergence_mac(torch.from_numpy(ufx),
                                           torch.from_numpy(ufy), dt, GRID.h)
    check_outputs([div], [gdiv])
    check_total(div, total, gtotal)


def pressure_bc(kind):
    """Neumann (the lid's), inhomogeneous Dirichlet x sides, periodic y."""
    if kind == "neumann":
        return jbc.default_scalar_bc(2)
    if kind == "dirichlet":
        return jbc.FieldBC(((jbc.Dirichlet(0.5), jbc.Dirichlet(-1.0)),
                            (jbc.Neumann(), jbc.Dirichlet(0.25))))
    return jbc.FieldBC(((jbc.Neumann(), jbc.Dirichlet(0.0)),
                        (jbc.Periodic(), jbc.Periodic())))


@pytest.mark.parametrize("with_cells", [False, True])
@pytest.mark.parametrize("kind", ["neumann", "dirichlet", "per_y"])
def test_correct_project_matches_pallas(kind, with_cells):
    fbc = pressure_bc(kind)
    spec = jbcg.kernel_spec(fbc)
    assert tbcg.kernel_spec(fieldbc_from_jax(fbc)) == spec
    n0, n1 = GRID.shape
    p, ufx, ufy, U, V = fields(2, (n0, n1), (n0 + 1, n1), (n0, n1 + 1),
                               (n0, n1), (n0, n1))
    dt = 0.29 * GRID.h
    kw = dict(sgn=spec["sgn"], off=spec["off"], per_y=spec["per_y"])
    cells = (U, V) if with_cells else None
    ref = jprojops.correct_project(
        jnp.asarray(p), jnp.asarray(ufx), jnp.asarray(ufy), dt, GRID.h,
        None if cells is None else tuple(map(jnp.asarray, cells)),
        S=STRIP, interpret=True, **kw)
    got = tprojops.correct_project(
        torch.from_numpy(p), torch.from_numpy(ufx), torch.from_numpy(ufy),
        dt, TGRID, fieldbc_from_jax(fbc),
        None if cells is None else tuple(map(torch.from_numpy, cells)))
    assert len(got) == 6
    if cells is None:
        assert got[4:] == (None, None)
        got = got[:4]
    check_outputs(ref, got)


@pytest.mark.parametrize("use_gp", [False, True])
@pytest.mark.parametrize("kind", ["lid", "per_y"])
def test_interp_faces_matches_pallas(kind, use_gp):
    """With the divergence fold (div_scale); the faces without it are the
    same faces."""
    su, sv = specs(kind)
    n0, n1 = GRID.shape
    U, V, Gx, Gy = fields(3, *[GRID.shape] * 4)
    dtv = 0.41 * GRID.h
    scale = 1.0 / (GRID.h * dtv)
    gp = (Gx, Gy) if use_gp else None
    ref = jprojops.interp_faces(
        jnp.asarray(U), jnp.asarray(V),
        None if gp is None else tuple(map(jnp.asarray, gp)),
        dtv if use_gp else None, sgn_u=su["sgn"], off_u=su["off"],
        sgn_v=sv["sgn"], off_v=sv["off"], per_y=su["per_y"],
        fbx=su["fb_x"], fby=sv["fb_y"], S=STRIP, div_scale=scale,
        interpret=True)
    u_bcs = [fieldbc_from_jax(b) for b in velocity_bcs(kind)]
    tU, tV = torch.from_numpy(U), torch.from_numpy(V)
    tgp = None if gp is None else tuple(map(torch.from_numpy, gp))
    got = tprojops.interp_faces(tU, tV, TGRID, u_bcs, tgp,
                                dtv if use_gp else None, div_scale=scale)
    assert len(got) == 6
    if gp is None:
        # no gc re-add: the cells are the given ones
        assert got[2] is tU and got[3] is tV
    out = got if gp is not None else got[:2] + got[4:]
    check_outputs(ref[:-1], out[:-1])
    check_total(ref[-2], ref[-1], out[-1])
    plain = tprojops.interp_faces(tU, tV, TGRID, u_bcs, tgp,
                                  dtv if use_gp else None)
    assert plain[4:] == (None, None)
    assert all(torch.equal(a, b) for a, b in zip(plain[:4], got[:4]))


def test_refused_bcs_take_the_torch_route():
    """BCs outside the kernels' encoding take the torch route, and it
    matches the JAX package's jnp route: an outflow (Neumann) x face of u
    for the face builders K6/K9, an inhomogeneous Neumann pressure BC for
    the correction K5.  64^2, float64."""
    from gerris_tpu.models import ns as jns
    from gerris_tpu.solvers import projection as jproj
    from gerris_tpu_torch.models import ns as tns
    from gerris_tpu_torch.solvers import projection as tproj
    from gerris_tpu_torch.utils.convert import grid_from_jax
    grid = JGrid(level=6)
    u_bc = jbc.FieldBC(((jbc.Dirichlet(1.0), jbc.Neumann()),
                        (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0))))
    v_bc = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2)
    p_bc = jbc.FieldBC(((jbc.Neumann(0.5), jbc.Neumann()),
                        (jbc.Neumann(), jbc.Neumann(-0.25))))
    tu = [fieldbc_from_jax(b) for b in (u_bc, v_bc)]
    tp = fieldbc_from_jax(p_bc)
    assert tbcg.face_specs(tu) is None and tbcg.kernel_spec(tp) is None
    tgrid = grid_from_jax(grid)
    n0, n1 = grid.shape
    U, V, Gx, Gy, p = fields(4, *[grid.shape] * 5)
    ufx, ufy = fields(5, (n0 + 1, n1), (n0, n1 + 1))
    dt = 0.3 * grid.h
    T = [torch.from_numpy(a) for a in (U, V, Gx, Gy, p, ufx, ufy)]
    J = [jnp.asarray(a) for a in (U, V, Gx, Gy, p, ufx, ufy)]

    jcfg = jns.NSConfig(grid=grid, u_bcs=(u_bc, v_bc), p_bc=p_bc)
    tcfg = tns.NSConfig(grid=tgrid, u_bcs=tuple(tu), p_bc=tp)
    ref = jns.predicted_face_velocities(J[:2], grid, jcfg, dt, 0.0)
    got, divp = tns.predicted_face_velocities(T[:2], tgrid, tcfg, dt)
    assert divp is None
    check_outputs(ref, got)
    ref = jproj.face_interpolated_velocity(J[:2], grid, [u_bc, v_bc],
                                           gp=J[2:4], dtv=dt)
    got = tproj.face_interpolated_velocity(T[:2], tgrid, tu, gp=T[2:4],
                                           dtv=dt)
    assert got[2] is None
    check_outputs(ref[0] + ref[1], got[0] + got[1])
    ref = jproj._mac_correct(J[5:7], J[4], grid, p_bc, dt, None, None,
                             J[:2])
    got = tprojops.correct_project_plain(T[4], T[5], T[6], dt, tgrid, tp,
                                         T[:2])
    check_outputs(ref[0] + ref[2] + ref[4], got)
