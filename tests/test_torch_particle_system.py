"""Two-way coupled particles and bubbles in the Simulation loop
(gerris_tpu_torch/models/particle_system.py, the PF sources of
models/ns.py, Simulation's particle_systems) on the CPU in float64.

The one live JAX run of the particle files: the coupled Simulation at
32^2 on a periodic box, 16 particles with drag and the bilinear deposit,
init + 3 steps against the JAX Simulation with its ParticleSystem
(eager), every field, PFx and PFy and the particle state within 1e-10 of
max.  The Gaussian deposit and a bubble system against the values pinned
from tools/particles_reference.py; the momentum gate of
tests/test_particles.py on the port (60 steps); timescale with the PF
fields; the carry-over of the configuration and of particle states; the
AMRSimulation's refusal; no read back to the host in a particle step."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.models.particle_system import ParticleSystem as JPS  # noqa: E402,E501
from gerris_tpu.models.simulation import Simulation as JSim  # noqa: E402
from gerris_tpu.models.simulation import Time as JTime  # noqa: E402
from gerris_tpu.physics import bubbles as jb  # noqa: E402
from gerris_tpu.physics import particles as jp  # noqa: E402
from gerris_tpu.solvers.poisson import MultilevelParams as JMP  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.models.particle_system import ParticleSystem  # noqa: E402,E501
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.physics import bubbles as tb  # noqa: E402
from gerris_tpu_torch.physics import particles as tp  # noqa: E402
from gerris_tpu_torch.solvers.poisson import MultilevelParams  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import particles_reference as pref  # noqa: E402

CPU = torch.device("cpu")
RTOL = 1e-10

# python3 tools/particles_reference.py: the JAX package's runs, init + 3
# steps at 32^2 in float64, each array's projections on NPROJ fixed
# arrays of normal deviates
JAX_PARTICLES = {
    "gaussian": {
        "fields": {
            "U": [-13.310858411153278, -16.81459397985721],
            "V": [2.0846852148672013, 2.111783145237033],
            "P": [-0.19772143354385358, 0.08976528929120828],
            "Pmac": [-0.2141537914802893, 0.07806865556569906],
            "Gx": [0.9662689747260369, 0.21163532089371598],
            "Gy": [0.7154692227872559, 1.691220947407366],
            "PFx": [-0.07352233520197311, 0.42470254373268135],
            "PFy": [-0.039137318975852806, 0.004056327386880054]},
        "particles": {
            "mass": [-0.005828483359648752, 0.002111304350991745],
            "pos": [-0.6700796494145425, 2.0615200383660253],
            "vel": [0.09148965753582156, -0.4077000815511167],
            "vol": [-0.0011656966719297507, 0.00042226087019834897]},
        "alive": 16, "t": 0.03},
    "bubbles": {
        "fields": {
            "U": [-13.312393302965294, -16.82101536323769],
            "V": [2.083792967094381, 2.1111135600087403],
            "P": [-0.19500176787059353, 0.07069821952192676],
            "Pmac": [-0.21427011072240246, 0.07426139082499399],
            "Gx": [0.9677169581046352, -0.006931273350348599],
            "Gy": [0.7702256232841285, 1.7468135633647377],
            "PFx": [-0.03482268435035963, -0.0020526061474716176],
            "PFy": [-0.0014790550853218706, 0.002290539268002487]},
        "particles": {
            "R": [-0.05025451834000927, 0.022765796404726715],
            "R0": [-0.04997132675578146, 0.022596832965714974],
            "Rdot": [-0.024085090794830705, 0.01503787379376599],
            "mass": [-2.8965990029399196e-08, 1.1662559564745185e-08],
            "p0": [-0.0042571511151648835, 0.002041580473747943],
            "pos": [-0.7041105938148942, 2.0704025838107976],
            "vel": [-1.4964945051853373, -0.027739301340268918],
            "vol": [-2.9409249922105613e-05, 1.1979810568711173e-05]},
        "alive": 16, "t": 0.03},
}


def periodic():
    return tbc.FieldBC.uniform(tbc.Periodic(), 2)


def port_cfg(**kw):
    """The port's coupled cavity of tools/particles_reference.py."""
    mp = MultilevelParams(**pref.params())
    return tns.NSConfig(grid=Grid(pref.LEVEL), u_bcs=(periodic(),) * 2,
                        nu=pref.NU, particle_coupling=True, projection=mp,
                        approx_projection=mp, diffusion_params=mp, **kw)


def port_run(case, steps=pref.STEPS):
    arrays, pkw, bkw = pref.particles(case)
    pcfg = tp.ParticleConfig(**pkw)
    if bkw is None:
        psys = ParticleSystem(pcfg, tp.make_particles(
            pref.NPART, 2, device=CPU, **arrays))
    else:
        psys = ParticleSystem(pcfg, tb.make_bubbles(
            pref.NPART, 2, device=CPU, **arrays),
            bubble_cfg=tb.BubbleConfig(**bkw))
    cfg = port_cfg()
    u, v = pref.initial_state(*cfg.grid.centers)
    sim = Simulation(cfg, time=Time(dtmax=pref.DTMAX), device=CPU,
                     particle_systems=[psys]).init(U=u, V=v)
    return sim.run(max_steps=steps), psys


def test_coupled_simulation_matches_the_live_reference():
    """init + 3 steps of 16 particles (drag, bilinear, two-way, mass
    loading 10) against the JAX Simulation and ParticleSystem, run
    eagerly: every field, PFx, PFy and the particle state within 1e-10 of
    max, the time equal."""
    rng = np.random.default_rng(2)
    n, vol = 16, 2e-4
    pos = rng.uniform(-0.4, 0.4, (n, 2))
    kw = dict(capacity=n, forces=("drag",), two_way=True)
    mp = JMP(**pref.params())
    jg = JGrid(pref.LEVEL)
    per = jbc.periodic_bc(2)
    jcfg = jns.NSConfig(grid=jg, u_bcs=(per, per), nu=pref.NU,
                        particle_coupling=True, projection=mp,
                        approx_projection=mp, diffusion_params=mp)
    arrays = dict(pos=pos, vol=np.full(n, vol), mass=np.full(n, 10 * vol))
    jsys = JPS(jp.ParticleConfig(**kw), jp.make_particles(n, 2, **arrays))
    u, v = pref.initial_state(*(np.asarray(c) for c in jg.centers))
    with jax.disable_jit():
        jsim = JSim(jcfg, time=JTime(dtmax=pref.DTMAX),
                    particle_systems=[jsys])
        jsim.init(U=u, V=v)
        jsim.run(max_steps=3)
    tsys = ParticleSystem(tp.ParticleConfig(**kw), tp.make_particles(
        n, 2, device=CPU, **arrays))
    tsim = Simulation(port_cfg(), time=Time(dtmax=pref.DTMAX), device=CPU,
                      particle_systems=[tsys]).init(U=u, V=v)
    tsim.run(max_steps=3)
    assert tsim.time.t == jsim.time.t and tsim.time.i == 3
    assert set(jsim.state) == set(tsim.state)
    for k, a in jsim.state.items():
        a = np.asarray(a)
        err = np.abs(a - tsim.state[k].numpy()).max() / np.abs(a).max()
        assert err <= RTOL, (k, err)
    for k, a in jsys.state.items():
        a = np.asarray(a, dtype=float)
        b = tsys.state[k].double().numpy()
        assert np.abs(a - b).max() <= RTOL * max(np.abs(a).max(), 1e-300), k
    np.testing.assert_allclose(tsys.last_force.numpy(),
                               np.asarray(jsys.last_force), rtol=0,
                               atol=RTOL * float(np.abs(
                                   np.asarray(jsys.last_force)).max()))


@pytest.mark.parametrize("case", pref.CASES)
def test_coupled_runs_match_the_pinned_reference(case):
    """The Gaussian deposit (radius 1.5 h, all five forces) and a bubble
    system (Rayleigh-Plesset with interactions, drag and added mass),
    init + 3 steps, against tools/particles_reference.py's JAX runs:
    every field's and particle array's projections within 1e-10."""
    sim, psys = port_run(case)
    ref = JAX_PARTICLES[case]
    assert sim.time.t == pytest.approx(ref["t"], rel=1e-15)
    assert psys.n_alive() == ref["alive"]
    assert not pref.mismatches(sim.state, ref["fields"], RTOL)
    st = {k: v for k, v in psys.state.items() if k != "alive"}
    assert not pref.mismatches(st, ref["particles"], RTOL)


def test_two_way_coupling_momentum():
    """tests/test_particles.py's gate on the port: heavy particles dragged
    by a uniform stream in a periodic box gain the x-momentum the fluid
    loses, within 20% over 60 steps."""
    grid = Grid(5)
    cfg = tns.NSConfig(grid=grid, u_bcs=(periodic(),) * 2, nu=1e-3,
                       particle_coupling=True)
    rng = np.random.default_rng(2)
    n, vol = 16, 2e-4
    pcfg = tp.ParticleConfig(capacity=n, forces=("drag",), two_way=True)
    psys = ParticleSystem(pcfg, tp.make_particles(
        n, 2, pos=rng.uniform(-0.4, 0.4, (n, 2)), vel=np.zeros((n, 2)),
        vol=np.full(n, vol), mass=np.full(n, 10.0 * vol), device=CPU))
    sim = Simulation(cfg, time=Time(end=1.0, dtmax=0.01), device=CPU,
                     particle_systems=[psys]).init(U=0.3)
    mom0 = float(sim.state["U"].sum()) * grid.cell_volume
    sim.run(max_steps=60)
    lost = mom0 - float(sim.state["U"].sum()) * grid.cell_volume
    gained = float((psys.state["vel"][:, 0] * psys.state["mass"]).sum())
    assert gained > 0.0 and lost > 0.0
    assert abs(lost - gained) / gained < 0.2


def test_timescale_takes_the_particle_forces():
    """timescale's acceleration bound sums max|body force| and max|PF| per
    component, as the JAX package's does."""
    rng = np.random.default_rng(4)
    jg = JGrid(5)
    per = jbc.periodic_bc(2)
    st = {k: rng.standard_normal(jg.shape) * s for k, s in
          (("U", 1e-3), ("V", 2e-3), ("PFx", 30.0), ("PFy", 5.0),
                     ("P", 1.0))}
    for bf in (None, (2.0, -50.0)):
        jcfg = jns.NSConfig(grid=jg, u_bcs=(per, per), nu=1e-3,
                            particle_coupling=True, body_force=bf)
        want = float(jns.timescale({k: jnp.asarray(v) for k, v in
                                    st.items()}, jcfg))
        got = tns.timescale({k: torch.as_tensor(v) for k, v in st.items()},
                            convert.config_from_jax(jcfg))
        assert float(got) == pytest.approx(want, rel=1e-14)
        assert want < min(jg.h / np.abs(st["U"]).max(),
                          jg.h / np.abs(st["V"]).max())


def test_config_and_states_carry_over():
    """config_from_jax carries particle_coupling (no field is left for a
    later slice); the particle and bubble configurations and states carry
    over field by field, alive as bool."""
    jcfg = jns.NSConfig(grid=JGrid(4), u_bcs=(jbc.periodic_bc(2),) * 2,
                        particle_coupling=True)
    assert convert.config_from_jax(jcfg).particle_coupling
    assert convert._LATER == {}
    jpc = jp.ParticleConfig(capacity=8, forces=("drag", "lift"), cd=0.4,
                            gravity=(0.0, -9.81, 0.0), two_way=True,
                            rkernel=0.05, kernel_cells=2)
    assert convert.particle_config_from_jax(jpc) == tp.ParticleConfig(
        **dataclasses.asdict(jpc))
    jbcfg = jb.BubbleConfig(model="keller_miksis", sigma=0.07,
                            interactions=True)
    assert convert.bubble_config_from_jax(jbcfg) == tb.BubbleConfig(
        **dataclasses.asdict(jbcfg))
    state = jb.make_bubbles(6, 2, np.zeros((4, 2)), R=np.full(4, 0.02))
    got = convert.particles_from_numpy(
        {k: np.asarray(v) for k, v in state.items()}, device=CPU)
    assert got["alive"].dtype == torch.bool and int(got["alive"].sum()) == 4
    for k, v in state.items():
        assert np.array_equal(np.asarray(v), got[k].numpy())


def test_amr_simulation_refuses_particle_coupling():
    """The reference's amr_step never reads particle_coupling
    (gerris_tpu/models/amr_ns.py): the port's AMRSimulation refuses it as
    it refuses the body force."""
    from gerris_tpu_torch.models import amr_ns
    cfg = chip_smoke.amr_osc_cfg(4)
    cfg = dataclasses.replace(cfg, particle_coupling=True)
    with pytest.raises(NotImplementedError, match="particle_coupling"):
        amr_ns.AMRSimulation(cfg, adapt=amr_ns.AdaptSpec(
            criterion=amr_ns.interface_vorticity_criterion, cmax=1e-2,
            minlevel=3, maxlevel=4), device=CPU)


def test_two_systems_add_their_forces():
    """A second system's reaction fields add to the first's (gerris_tpu
    particle_system.py:60-69): two systems of the same particles give
    twice one system's PF."""
    def run(nsys):
        arrays, pkw, _ = pref.particles("gaussian")
        systems = [ParticleSystem(tp.ParticleConfig(**pkw),
                                  tp.make_particles(pref.NPART, 2,
                                                    device=CPU, **arrays))
                   for _ in range(nsys)]
        cfg = port_cfg()
        u, v = pref.initial_state(*cfg.grid.centers)
        sim = Simulation(cfg, time=Time(dtmax=pref.DTMAX), device=CPU,
                         particle_systems=systems).init(U=u, V=v)
        sim.run(max_steps=1)
        return sim.state
    one, two = run(1), run(2)
    for k in ("PFx", "PFy"):
        assert float(one[k].abs().max()) > 0.0
        torch.testing.assert_close(two[k], 2.0 * one[k], rtol=1e-14,
                                   atol=1e-14)


def test_particle_step_reads_nothing_back():
    """A coupled step reads back to the host what the step without
    particles reads, its solves' condition reads and the CFL dt's (two
    in a run of one step: Simulation.run sets the step before and after
    it), and the particle phase nothing (chip_smoke.count_syncs counts
    the reading tensor calls on the CPU)."""
    sim, psys = port_run("gaussian", steps=2)
    with chip_smoke.recording_solves() as log:
        n, _ = chip_smoke.count_syncs(lambda: sim.run(max_steps=1), CPU)
    assert n == sum(x[3] for x in log) + 2
    reads, _ = chip_smoke.count_syncs(lambda: psys.step(sim), CPU)
    assert reads == 0
