"""Rigid bodies moved by the fluid (gerris_tpu_torch/models/rigid.py)
against the JAX package on the CPU in float64.

solid_force to 1e-12 of the JAX package's (pressure and viscous), the
moving step's context with a rigid body's state as ``solid_args`` (the
surface velocity a function of it) to the last bits of the JAX
package's, the buoyancy gate of tests/test_rigid.py and the falling
disk on the port.  The port's counterpart of the reference's
test_accelerating_disk_no_retrace is that a RigidBodyDriver step reads
nothing back from the device beyond what its ns_step reads.  No JAX step
runs in this file."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.models import rigid as jrigid  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models import rigid  # noqa: E402
from gerris_tpu_torch.solvers.poisson import MultilevelParams  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

CPU = torch.device("cpu")
R = 0.2


def _jphi(x, y, t, cx, cy, vx, vy):
    return jnp.sqrt((x - cx) ** 2 + (y - cy) ** 2) - R


def _tphi(x, y, t, cx, cy, vx, vy):
    return torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - R


def _configs(level, nu, surface_u=None, **kw):
    """The JAX config of a disk moved by ``solid_args`` and the port's,
    carried over (``surface_u``'s functions serve both: they return an
    argument)."""
    jcfg = jns.NSConfig(grid=JGrid(level), u_bcs=(jbc.velocity_bc(0, 2),
                                                  jbc.velocity_bc(1, 2)),
                        nu=nu, solid_phi=_jphi, moving_solid=True,
                        surface_u=surface_u, **kw)
    return jcfg, convert.config_from_jax(jcfg, solid_phi=_tphi,
                                         surface_u=surface_u)


ARGS = (0.03, -0.05, 0.1, 0.2)


@pytest.mark.parametrize("nu", [0.0, 0.01])
def test_solid_force_matches_jax(nu):
    """The force on a disk at (0.03, -0.05) from a seeded pressure and
    velocity at level 6, with and without the viscous stress, within
    1e-12 of the JAX package's."""
    jcfg, tcfg = _configs(6, nu)
    rng = np.random.default_rng(2)
    st = {k: rng.standard_normal(jcfg.grid.shape) for k in ("P", "U", "V")}
    jf = jrigid.solid_force({k: jnp.asarray(v) for k, v in st.items()},
                            jcfg, jnp.asarray(0.1),
                            tuple(jnp.asarray(a) for a in ARGS))
    tf = rigid.solid_force(convert.state_from_numpy(st, device="cpu"), tcfg,
                           0.1, tuple(torch.tensor(a, dtype=torch.float64)
                                      for a in ARGS))
    for a, b in zip(jf, tf):
        assert b.dim() == 0
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(a))


@pytest.mark.parametrize("order", [1, 2])
def test_moving_weights_with_a_bodys_state_match_jax(order):
    """The moving step's context with a body's state as solid_args and the
    RigidBodyDriver's surface velocity (x, y, t, cx, cy, vx, vy) -> (vx,
    vy): the
    fractions, the fill and both divergence sources against the JAX
    package's _moving_solid_ctx at level 5, to 1e-13."""
    def us_u(x, y, t, cx, cy, vx, vy):
        return vx

    def us_v(x, y, t, cx, cy, vx, vy):
        return vy

    jcfg, tcfg = _configs(5, 0.0, surface_u=(us_u, us_v),
                          moving_order=order)
    grid = tcfg.grid
    rng = np.random.default_rng(4)
    u, v = (rng.standard_normal(grid.shape) for _ in range(2))
    dt, t = 0.25 * grid.h, 0.05
    jsol, jU, jmac, japx = jns._moving_solid_ctx(
        jcfg, [jnp.asarray(u), jnp.asarray(v)], dt, t,
        tuple(jnp.asarray(a) for a in ARGS))
    w, U, mac, apx = tns._moving_weights(
        tcfg, [torch.from_numpy(u), torch.from_numpy(v)], dt, t,
        tuple(torch.tensor(a, dtype=torch.float64) for a in ARGS))
    pairs = [(jsol[0], w.a), (jsol[1][0], w.s[0]), (jsol[1][1], w.s[1]),
             (jU[0], U[0]), (jU[1], U[1]), (jmac, mac), (japx, apx)]
    if order == 2:
        pairs += [(jsol[4][0], w.s_half[0]), (jsol[5], w.a_old)]
    for ref, got in pairs:
        ref = np.asarray(ref)
        assert np.max(np.abs(ref - got.numpy())) <= 1e-13 * max(
            np.max(np.abs(ref)), 1.0)


def test_buoyancy_force():
    """tests/test_rigid.py::test_hydrostatic_buoyancy_force on the port (the
    card's gate too, chip_smoke.moving_gate): Archimedes' force within
    5%, nothing across."""
    fx, fy, exact = chip_smoke.buoyancy(CPU)
    assert abs(fx) < 0.02 * abs(exact)
    assert abs(fy - exact) < chip_smoke.BUOYANCY_RTOL * abs(exact)


def _falling_body(level=5):
    return rigid.RigidBodyDriver(
        Grid(level), chip_smoke.walls(), chip_smoke.rigid_shape,
        rigid.RigidBody(mass=chip_smoke.RIGID_MASS,
                        pos=(0.0, chip_smoke.RIGID_Y0),
                        gravity=(0.0, chip_smoke.RIGID_G)),
        device="cpu",
        projection=MultilevelParams(tolerance=1e-6, nitermax=40),
        approx_projection=MultilevelParams(tolerance=1e-6, nitermax=40))


def test_falling_disk():
    """tests/test_rigid.py::test_accelerating_disk_no_retrace's physics on
    the port: the gravity-driven disk moves down and gains downward speed,
    slower than free fall (the added mass), its history finite; the body's
    state stays 0-d tensors on the device, read once (trajectory)."""
    drv = _falling_body()
    dt = 0.25 * drv.cfg.grid.h
    for _ in range(6):
        drv.step(dt)
    b = drv.body
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0
               for x in (*b.pos, *b.vel))
    traj = drv.trajectory()
    assert traj.shape == (6, 7) and np.isfinite(traj).all()
    assert traj[-1, 2] < chip_smoke.RIGID_Y0
    assert traj[-1, 4] < 0.0
    assert traj[-1, 4] > chip_smoke.RIGID_G * drv.t * 1.5


def test_body_step_reads_no_more_than_its_step():
    """The port's counterpart of test_accelerating_disk_no_retrace: a
    RigidBodyDriver step makes the host reads of the ns_step it runs and no
    other (the force, the acceleration and the motion stay on the
    device; chip_smoke.count_syncs counts on the CPU the calls that
    would sync the card)."""
    drv = _falling_body()
    dt = 0.25 * drv.cfg.grid.h
    drv.step(dt)
    args = (*drv.body.pos, *drv.body.vel)
    with chip_smoke.recording_solves() as log:
        n_step, _ = chip_smoke.count_syncs(
            lambda: tns.ns_step(drv.state, dt, drv.t, drv.cfg,
                                solid_args=args), CPU)
    n_drv, _ = chip_smoke.count_syncs(lambda: drv.step(dt), CPU)
    assert n_step == sum(x[3] for x in log) + chip_smoke.MOVING_SYNCS
    assert n_drv == n_step


def test_viscous_rigid_body_is_refused():
    """A viscous rigid body: the surface velocity, a function of the
    body's state, cannot be evaluated on the Dirichlet surface as the
    reference calls it there, f(x, y); the port refuses the step."""
    drv = rigid.RigidBodyDriver(
        Grid(4), chip_smoke.walls(), chip_smoke.rigid_shape,
        rigid.RigidBody(mass=0.1, pos=(0.0, 0.2), gravity=(0.0, -1.0)),
        nu=1e-3, device="cpu")
    with pytest.raises(NotImplementedError, match="f\\(x, y\\)"):
        drv.step(0.25 * drv.cfg.grid.h)


def test_rigid_body_from_jax():
    """A JAX RigidBody crosses as floats (numpy)."""
    jb = jrigid.RigidBody(mass=0.1, pos=(jnp.asarray(0.0), 0.2),
                          vel=(0.0, jnp.asarray(-0.5)), gravity=(0.0, -1.0))
    b = convert.rigid_body_from_jax(jb)
    assert b == rigid.RigidBody(mass=0.1, pos=(0.0, 0.2), vel=(0.0, -0.5),
                                gravity=(0.0, -1.0))
    assert all(type(x) is float for x in (*b.pos, *b.vel, *b.gravity))
