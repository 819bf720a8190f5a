"""The Lagrangian particles (gerris_tpu_torch/physics/particles.py) against
the JAX package on the CPU in float64.

Each function on the same numpy inputs from a seed, at 32^2 and 16^3,
within 1e-12 of max: the state, the interpolation on every BC kind, each
force model alone and all five, the Cd(Re) law across Re 1e-9 .. 200, the
step with its periodic wrap and its deactivation out of the box, both
deposits, the volume fraction, the reaction fields and the feed over
capacity.  Then the gates of tests/test_particles.py on the port, the
buoyancy the reference's reaction force carries and the free slot 0 its
feed loses (ROADMAP Queue 3), the dtype guards and the Gaussian
deposit's centroid shift.  No JAX step of
the flow runs in this file."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.models.particle_system import ParticleSystem as JPS  # noqa: E402,E501
from gerris_tpu.physics import particles as jp  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models.particle_system import ParticleSystem  # noqa: E402,E501
from gerris_tpu_torch.physics import particles as tp  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

CPU = torch.device("cpu")
RTOL = 1e-12
FORCES = ("drag", "lift", "buoy", "inertial", "added_mass")


def close(a, b, rtol=RTOL):
    """max|a - b| within rtol of max|a| (a the JAX package's)."""
    a = np.asarray(a, dtype=np.float64)
    b = b.double().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-300) if a.size else 1.0
    err = np.abs(a - b).max() / scale if a.size else 0.0
    assert err <= rtol, err


def same_state(jstate, tstate, rtol=RTOL):
    assert set(jstate) == set(tstate)
    for k in jstate:
        if k == "alive":
            assert tstate[k].dtype == torch.bool
            assert np.array_equal(np.asarray(jstate[k]), tstate[k].numpy())
        else:
            close(jstate[k], tstate[k], rtol)


def bcs_of(kind, dim):
    """(JAX, port) velocity BCs of one kind: walls, periodic, or the lid's
    (a Dirichlet 1 top)."""
    if kind == "periodic":
        return ([jbc.periodic_bc(dim)] * dim,
                [tbc.FieldBC.uniform(tbc.Periodic(), dim)] * dim)
    if kind == "walls":
        return ([jbc.velocity_bc(c, dim) for c in range(dim)],
                [tbc.velocity_bc(c, dim) for c in range(dim)])
    j = [jbc.FieldBC.make(dim, default=jbc.Dirichlet(0.0),
                          top=jbc.Dirichlet(1.0))] + \
        [jbc.FieldBC.uniform(jbc.Dirichlet(0.0), dim)] * (dim - 1)
    t = [tbc.FieldBC.make(dim, default=tbc.Dirichlet(0.0),
                          top=tbc.Dirichlet(1.0))] + \
        [tbc.FieldBC.uniform(tbc.Dirichlet(0.0), dim)] * (dim - 1)
    return j, t


def grids(dim):
    level = 5 if dim == 2 else 4
    return JGrid(level=level, dim=dim), Grid(level=level, dim=dim)


def seeded(dim, n=40, cap=48, seed=0, spread=0.52):
    """Seeded fields and particles: velocities and old velocities, and n
    particles in a box a little larger than the domain."""
    rng = np.random.default_rng(seed)
    jg, tg = grids(dim)
    U = [rng.standard_normal(tg.shape) for _ in range(dim)]
    Uo = [u + 0.1 * rng.standard_normal(tg.shape) for u in U]
    pos = rng.uniform(-spread, spread, (n, dim))
    vel = 0.2 * rng.standard_normal((n, dim))
    vol = rng.uniform(1e-5, 1e-4, n)
    mass = vol * rng.uniform(0.5, 3.0, n)
    J = jp.make_particles(cap, dim, pos=pos, vel=vel, vol=vol, mass=mass)
    T = tp.make_particles(cap, dim, pos=pos, vel=vel, vol=vol, mass=mass,
                          device=CPU)
    return jg, tg, U, Uo, J, T


def jarr(fields):
    return [jnp.asarray(f) for f in fields]


def tarr(fields):
    return [torch.as_tensor(f) for f in fields]


@pytest.mark.parametrize("dim", [2, 3])
def test_make_particles_matches_jax(dim):
    """The slots, the 1e-12 fills of the dead ones and alive as bool."""
    _, _, _, _, J, T = seeded(dim)
    same_state(J, T, 0.0)
    same_state(jp.make_particles(8, dim, n=3),
               tp.make_particles(8, dim, n=3, device=CPU), 0.0)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["walls", "periodic", "lid"])
def test_interpolate_at_matches_jax(dim, kind):
    """The gather at particles in and a little outside the box, on each
    BC kind's ghosts."""
    jg, tg, U, _, J, T = seeded(dim)
    jb, tb = bcs_of(kind, dim)
    for c in range(dim):
        close(jp.interpolate_at(jnp.asarray(U[c]), jg, jb[c], J["pos"]),
              tp.interpolate_at(torch.as_tensor(U[c]), tg, tb[c],
                                T["pos"]))


def forces_at(dim, kind="walls", seed=0):
    jg, tg, U, Uo, J, T = seeded(dim, seed=seed, spread=0.45)
    jb, tb = bcs_of(kind, dim)
    ja = [jp.interpolate_at(jnp.asarray(u), jg, jb[c], J["pos"])
          for c, u in enumerate(U)]
    jo = [jp.interpolate_at(jnp.asarray(u), jg, jb[c], J["pos"])
          for c, u in enumerate(Uo)]
    rng = np.random.default_rng(seed + 1)
    conv = rng.standard_normal((J["pos"].shape[0], dim))
    vort = rng.standard_normal(J["pos"].shape[0] if dim == 2 else
                               (J["pos"].shape[0], dim))
    return J, T, jnp.stack(ja, 1), jnp.stack(jo, 1), conv, vort


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("forces", [(f,) for f in FORCES] + [FORCES],
                         ids=lambda f: "+".join(f))
def test_compute_forces_matches_jax(forces, dim):
    """Each force model alone and all five, with the Cd(Re) law and a
    constant cd, gravity on every axis."""
    J, T, ua, uo, conv, vort = forces_at(dim)
    for cd in (None, 0.7):
        kw = dict(capacity=48, forces=forces, cd=cd,
                  gravity=(0.3, -1.0, 0.5), fluid_rho=1.2)
        jf, jm = jp.compute_forces(J, ua, uo, jnp.asarray(conv),
                                   jnp.asarray(vort),
                                   jp.ParticleConfig(**kw), 1e-2, 0.01)
        tf, tm = tp.compute_forces(
            T, torch.as_tensor(np.asarray(ua)), torch.as_tensor(
                np.asarray(uo)), torch.as_tensor(conv),
            torch.as_tensor(vort), tp.ParticleConfig(**kw), 1e-2, 0.01)
        close(jf, tf)
        close(jm, tm)


def test_drag_law_across_re_matches_jax():
    """The Cd(Re) law (particulatecommon.c:584-590) from Re 1e-9 (no drag
    below 1e-8) through its switch at 50 to 200, at nu = 0 (the
    reference's fallback viscosity 1e-3) and nu = 1e-2."""
    n = 64
    re = np.geomspace(1e-9, 200.0, n)
    vol = np.full(n, 1e-4)
    dia = float(jp.particle_diameter(jnp.asarray(1e-4)))
    for nu in (0.0, 1e-2):
        visc = nu if nu > 0 else 1e-3
        speed = re * visc / dia
        pos = np.zeros((n, 2))
        vel = np.stack([-speed, 0 * speed], 1)
        J = jp.make_particles(n, 2, pos=pos, vel=vel, vol=vol, mass=vol)
        T = tp.make_particles(n, 2, pos=pos, vel=vel, vol=vol, mass=vol,
                              device=CPU)
        cfg = dict(capacity=n, forces=("drag",))
        z = np.zeros((n, 2))
        jf, _ = jp.compute_forces(J, jnp.asarray(z), jnp.asarray(z),
                                  jnp.asarray(z), jnp.zeros(n),
                                  jp.ParticleConfig(**cfg), nu, 0.01)
        tf, _ = tp.compute_forces(T, torch.zeros(n, 2, dtype=torch.float64),
                                  torch.zeros(n, 2, dtype=torch.float64),
                                  torch.zeros(n, 2, dtype=torch.float64),
                                  torch.zeros(n, dtype=torch.float64),
                                  tp.ParticleConfig(**cfg), nu, 0.01)
        close(jf, tf)
        assert float(tf[0, 0]) == 0.0 and float(tf[-1, 0]) > 0.0


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["walls", "periodic"])
def test_step_particles_matches_jax(dim, kind):
    """One step of all five forces with gravity: the new state (the
    periodic wrap, or the particles leaving the walled box deactivated)
    and the total force; the force without buoyancy is the total less
    (rho_p - rho_f) g vol."""
    jg, tg, U, Uo, J, T = seeded(dim)
    jb, tb = bcs_of(kind, dim)
    kw = dict(capacity=48, gravity=(0.2, -1.0, 0.1))
    jn, jt = jp.step_particles(J, jarr(U), jarr(Uo), jg, jb,
                               jp.ParticleConfig(**kw), 1e-2, 0.05)
    tn, tt, th = tp.step_particles(T, tarr(U), tarr(Uo), tg, tb,
                                   tp.ParticleConfig(**kw), 1e-2, 0.05)
    same_state(jn, tn)
    close(jt, tt)
    buoy = tp.buoyancy_density(T, tp.ParticleConfig(**kw), dim) * \
        T["vol"][:, None]
    close(np.asarray(jt) - buoy.numpy(), th, 1e-11)
    alive = tn["alive"].numpy()
    if kind == "walls":
        assert alive[:40].sum() < 40 and not alive[40:].any()
    else:
        assert alive[:40].all()
        x = tn["pos"].numpy()
        assert (x >= -0.5).all() and (x <= 0.5).all()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("rkernel", [0.0, 1.5], ids=["bilinear",
                                                     "gaussian"])
def test_deposit_matches_jax(dim, rkernel):
    """Both deposits (rkernel in cells) of seeded values from particles
    in the box and across its edges, the dead slots adding nothing; the
    volume fraction and the reaction fields too."""
    jg, tg, _, _, J, T = seeded(dim, spread=0.53)
    vals = np.random.default_rng(3).standard_normal(48)
    kw = dict(capacity=48, rkernel=rkernel * tg.h, kernel_cells=2)
    jc, tc = jp.ParticleConfig(**kw), tp.ParticleConfig(**kw)
    close(jp.deposit(jnp.asarray(vals), J, jg, jc),
          tp.deposit(torch.as_tensor(vals), T, tg, tc))
    close(jp.volume_fraction_field(J, jg, jc),
          tp.volume_fraction_field(T, tg, tc))
    f = np.random.default_rng(4).standard_normal((48, dim))
    for a, b in zip(jp.reaction_force_fields(jnp.asarray(f), J, jg, jc),
                    tp.reaction_force_fields(torch.as_tensor(f), T, tg, tc)):
        close(a, b)


def test_feed_particles_over_capacity_matches_jax():
    """Injections into the first free slots; those beyond them dropped,
    the live slots untouched (slot 0 is live: where it is free and an
    injection is dropped, gerris_tpu's scatter writes slot 0 twice)."""
    _, _, _, _, J, T = seeded(2, n=5, cap=12)
    J = dict(J, alive=J["alive"].at[2].set(False))
    T = dict(T, alive=T["alive"].clone())
    T["alive"][2] = False
    new = np.random.default_rng(5).uniform(-0.4, 0.4, (9, 2))
    same_state(jp.feed_particles(J, new, vol=2e-5, rho_p=3.0),
               tp.feed_particles(T, new, vol=2e-5, rho_p=3.0), 0.0)
    same_state(jp.feed_particles(J, new[:3], vel=new[:3], vol=new[:3, 0],
                                 mass=new[:3, 1]),
               tp.feed_particles(T, new[:3], vel=new[:3], vol=new[:3, 0],
                                 mass=new[:3, 1]), 0.0)


def test_feed_over_capacity_keeps_a_free_slot_zero():
    """Slot 0 free, four injections into three free slots: gerris_tpu's
    feed points each dropped injection at slot 0 with slot 0's old
    values, and its scatter keeps the last write, so the particle fed
    into slot 0 is lost and the slot stays free (ROADMAP Queue 3); the
    port sends dropped injections to a scratch slot and fills all
    three."""
    pos = [[0.1, 0.1], [0.2, 0.2]]
    new = np.array([[0.3, 0.3], [0.4, 0.4], [0.45, 0.45], [0.49, 0.49]])
    J = jp.make_particles(4, 2, pos=pos)
    J = dict(J, alive=J["alive"].at[0].set(False))
    ref = jp.feed_particles(J, new, vol=1e-5)
    assert np.asarray(ref["alive"]).tolist() == [False, True, True, True]
    T = tp.make_particles(4, 2, pos=pos, device=CPU)
    T["alive"][0] = False
    got = tp.feed_particles(T, new, vol=1e-5)
    assert got["alive"].tolist() == [True, True, True, True]
    assert got["pos"][[0, 2, 3]].tolist() == new[:3].tolist()
    assert got["pos"][1].tolist() == pos[1]


# -- the gates of tests/test_particles.py on the port ------------------------

def test_interpolation_exact_linear():
    """The bilinear gather reproduces a linear field at random points."""
    grid = Grid(level=5)
    x, y = (torch.as_tensor(c) for c in grid.centers)
    f = 2.0 * x - 3.0 * y + 0.25
    pos = torch.as_tensor(np.random.default_rng(0).uniform(-0.45, 0.45,
                                                           (64, 2)))
    vals = tp.interpolate_at(f, grid, tbc.FieldBC.uniform(tbc.Periodic()),
                             pos)
    exact = 2.0 * pos[:, 0] - 3.0 * pos[:, 1] + 0.25
    assert float((vals - exact).abs().max()) < 1e-12


def _uniform(grid, u0, v0=0.0):
    return [torch.full(grid.shape, u0, dtype=torch.float64),
            torch.full(grid.shape, v0, dtype=torch.float64)]


def test_drag_relaxation():
    """A heavy particle released at rest in a uniform stream approaches
    the stream's velocity monotonically (the Cd(Re) law)."""
    grid = Grid(level=5)
    per = [tbc.FieldBC.uniform(tbc.Periodic())] * 2
    U = _uniform(grid, 0.5)
    cfg = tp.ParticleConfig(capacity=8, forces=("drag",))
    p = tp.make_particles(8, 2, pos=[[0.0, 0.0]], vel=[[0.0, 0.0]],
                          vol=[1e-4], mass=[5e-4], device=CPU)
    vels = []
    for _ in range(200):
        p, _, _ = tp.step_particles(p, U, U, grid, per, cfg, nu=1e-2,
                                    dt=0.01)
        vels.append(float(p["vel"][0, 0]))
    v = np.array(vels)
    assert np.all(np.diff(v) >= -1e-12)
    assert abs(v[-1] - 0.5) < 0.05 * 0.5 and v[-1] < 0.5 + 1e-9


def test_buoyancy_terminal_velocity():
    """A light particle under gravity and drag reaches the velocity where
    buoyancy balances drag."""
    grid = Grid(level=5)
    per = [tbc.FieldBC.uniform(tbc.Periodic())] * 2
    U = _uniform(grid, 0.0)
    vol, rho_p, cd = 1e-4, 0.5, 1.0
    dia = float(tp.particle_diameter(torch.tensor(vol)))
    cfg = tp.ParticleConfig(capacity=4, forces=("drag", "buoy"), cd=cd,
                            gravity=(0.0, -1.0))
    p = tp.make_particles(4, 2, pos=[[0.0, -0.3]], vel=[[0.0, 0.0]],
                          vol=[vol], mass=[rho_p * vol], device=CPU)
    for _ in range(2000):
        p, _, _ = tp.step_particles(p, U, U, grid, per, cfg, nu=1e-2,
                                    dt=0.002)
    v = float(p["vel"][0, 1])
    expect = math.sqrt(4.0 * dia * (1.0 - rho_p) / (3.0 * cd))
    assert v > 0 and abs(v - expect) / expect < 0.02


def test_deposit_conserves_total():
    grid = Grid(level=5)
    rng = np.random.default_rng(1)
    p = tp.make_particles(32, 2, pos=rng.uniform(-0.3, 0.3, (32, 2)),
                          device=CPU)
    vals = torch.as_tensor(rng.uniform(0.5, 1.5, 32))
    for rk in (0.0, 0.05):
        field = tp.deposit(vals, p, grid, tp.ParticleConfig(32, rkernel=rk))
        total = float(field.sum()) * grid.cell_volume
        assert abs(total - float(vals.sum())) < 1e-10, rk


def test_feed_particles():
    """GfsFeedParticle (particulatecommon.c:2377): two fed, the volumes
    summed, the over-capacity injections dropped."""
    p = tp.make_particles(8, 2, pos=[[0.0, 0.0]], vol=[1e-4], mass=[1e-4],
                          device=CPU)
    assert int(p["alive"].sum()) == 1
    p2 = tp.feed_particles(p, [[0.1, 0.1], [0.2, 0.2]], vol=2e-4)
    assert int(p2["alive"].sum()) == 3
    assert float(torch.where(p2["alive"], p2["vol"], 0.0).sum()) == \
        pytest.approx(1e-4 + 2 * 2e-4)
    p3 = tp.feed_particles(p2, np.zeros((10, 2)), vol=1e-5)
    assert int(p3["alive"].sum()) == 8
    assert torch.equal(p3["pos"][:3], p2["pos"][:3])


# -- the reference's faults and properties (ROADMAP Queue 3) -----------------

class _Sim:
    """What ParticleSystem.step reads of a simulation, for both packages."""

    def __init__(self, cfg, state, systems):
        self.cfg, self.state, self.prev_state = cfg, state, None
        self.particle_systems, self.dt = systems, 0.01

        class T:
            t = 0.0
        self.time = T


def test_reaction_force_leaves_buoyancy_out():
    """A particle at rest (rho_p / rho_f = 3) in fluid at rest under
    gravity (0, -1), two-way: gerris_tpu's ParticleSystem deposits the
    total force, so its PFy holds -(rho_p - rho_f) g vol spread over the
    particle's cells (2 vol / h^2 in all), where the reference C's
    compute_forces_onfluid (particulatecommon.c:754-766), and the port,
    leave buoyancy out: the port's PFy is 0.  The particle itself feels
    the buoyancy in both."""
    vol = 1e-4
    kw = dict(capacity=4, gravity=(0.0, -1.0), two_way=True)
    jg, tg = grids(2)
    jcfg = jns.NSConfig(grid=jg, u_bcs=tuple(bcs_of("walls", 2)[0]),
                        nu=1e-2, particle_coupling=True)
    zeros = jnp.zeros(jg.shape)
    jsys = JPS(jp.ParticleConfig(**kw), jp.make_particles(
        4, 2, pos=[[0.01, 0.02]], vol=[vol], mass=[3 * vol]))
    jsim = _Sim(jcfg, {"U": zeros, "V": zeros, "P": zeros}, [jsys])
    jsys.step(jsim)
    tcfg = convert.config_from_jax(jcfg)
    tz = torch.zeros(tg.shape, dtype=torch.float64)
    tsys = ParticleSystem(tp.ParticleConfig(**kw), tp.make_particles(
        4, 2, pos=[[0.01, 0.02]], vol=[vol], mass=[3 * vol], device=CPU))
    tsim = _Sim(tcfg, {"U": tz, "V": tz, "P": tz}, [tsys])
    tsys.step(tsim)
    ref = float(jnp.sum(jsim.state["PFy"])) * jg.cell_volume
    assert ref == pytest.approx(2.0 * vol, rel=1e-12)
    assert float(jnp.abs(jsim.state["PFx"]).max()) == 0.0
    assert float(tsim.state["PFy"].abs().max()) == 0.0
    assert float(tsim.state["PFx"].abs().max()) == 0.0
    close(jsys.last_force, tsys.last_force)
    assert float(tsys.last_force[0, 1]) == pytest.approx(-2.0 * vol)


def test_guards_are_the_dtype_tiny():
    """The reference's 1e-300 guards are 0 in float32; the port's are the
    dtype's smallest normal number.  A float32 Gaussian deposit whose
    weights all underflow (a particle 30 radii from every cell it
    reaches) adds 0 where 1e-300 would give 0/0; a zero volume gives a
    finite buoyancy; dt = 0 a finite inertial force."""
    assert torch.tensor(1e-300, dtype=torch.float32) == 0.0
    grid = Grid(level=5)
    p = tp.make_particles(2, 2, pos=[[0.0, 0.0], [5.0, 5.0]], vol=[1e-4, 0.0],
                          mass=[1e-4, 1e-4], device=CPU, dtype=torch.float32)
    cfg = tp.ParticleConfig(2, rkernel=0.1 * grid.h, gravity=(0.0, -1.0))
    field = tp.deposit(torch.ones(2), p, grid, cfg)
    assert bool(torch.isfinite(field).all())
    assert float(field.sum()) * grid.cell_volume == pytest.approx(1.0)
    z = torch.zeros(2, 2)
    cfg = tp.ParticleConfig(2, forces=("buoy", "inertial", "added_mass"),
                            gravity=(0.0, -1.0))
    f, _ = tp.compute_forces(p, z, z, z, torch.zeros(2), cfg, 1e-2, 0.0)
    assert bool(torch.isfinite(f).all())


@pytest.mark.parametrize("rk,least,most", [(1.5, 0.14, 0.15),
                                           (1.0, 0.013, 0.015)])
def test_gaussian_window_shifts_the_centroid(rk, least, most):
    """A property of the reference's Gaussian deposit, copied by the port:
    its window idx0 + 1 - K .. idx0 + 1 + K (gerris_tpu particles.py:
    292-300) is not centred on the particle, so the deposit's centroid
    lies off it by up to 0.145 h at rkernel = 1.5 h and 0.0139 h at
    rkernel = h with K = 3 (the largest over 40 particles swept across a
    cell, at the cell centre), the same on the JAX package."""
    grid = Grid(level=5)
    h = grid.h
    s = np.linspace(0.0, 1.0, 41)[:-1]
    pos = np.stack([s * h, np.full_like(s, 0.3 * h)], 1)
    cfg = dict(capacity=len(s), rkernel=rk * h, kernel_cells=3)
    p = tp.make_particles(len(s), 2, pos=pos, device=CPU)
    flat, factors = tp.deposit_stencil(p, grid, tp.ParticleConfig(**cfg))
    x = torch.as_tensor(grid.centers[0]).reshape(-1)[flat]
    shift = ((factors[0] * x).sum(1) - p["pos"][:, 0]) / h
    assert least <= float(shift.abs().max()) <= most
    J = jp.make_particles(len(s), 2, pos=pos)
    for k in range(0, len(s), 8):
        one = np.zeros(len(s))
        one[k] = 1.0
        d = np.asarray(jp.deposit(jnp.asarray(one), J, JGrid(5),
                                  jp.ParticleConfig(**cfg)))
        cx = (d * np.asarray(JGrid(5).centers[0])).sum() / d.sum()
        assert abs((cx - pos[k, 0]) / h - float(shift[k])) < 1e-10
