"""The port's variable and event classes (gerris_tpu_torch/events/
variables.py, events/events.py) with the assertions of
tests/test_events2.py, tests/test_les.py and the variable tests of
tests/test_misc2.py, on the CPU in float64; the LES viscosity, the
position and the Laplacian against the JAX package's on the same field;
and the reference's faults this slice meets (the AMR viscosity stack,
the float32 guards)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from gerris_tpu.events import variables as jvar  # noqa: E402

from gerris_tpu_torch.core import bc as bcs  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.events import variables as ev  # noqa: E402
from gerris_tpu_torch.events.events import EventStop  # noqa: E402
from gerris_tpu_torch.models import ns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.physics import vof  # noqa: E402
from gerris_tpu_torch.utils import gfs_config as G  # noqa: E402

F64 = torch.float64


def _sim(level=5, vof_tracer=False, dtype=F64):
    grid = Grid(level=level, dim=2)
    kw = {}
    if vof_tracer:
        kw["vof_tracers"] = (("T", bcs.default_scalar_bc(2)),)
    cfg = ns.NSConfig(grid=grid, u_bcs=(bcs.velocity_bc(0, 2),
                                        bcs.velocity_bc(1, 2)), nu=0.0, **kw)
    return Simulation(cfg, time=Time(iend=0), device="cpu",
                      dtype=dtype).init()


def _centres(grid):
    return [torch.as_tensor(c) for c in np.broadcast_arrays(*grid.centers)]


# --- tests/test_events2.py ------------------------------------------------

def test_navier_bc_limits():
    grid = Grid(level=4, dim=2)
    u = torch.arange(16.0 * 16, dtype=F64).reshape(16, 16) / 256.0
    nav0 = bcs.FieldBC.uniform(bcs.Navier(0.0), 2)
    diri = bcs.FieldBC.uniform(bcs.Dirichlet(0.0), 2)
    navinf = bcs.FieldBC.uniform(bcs.Navier(1e12), 2)
    neum = bcs.FieldBC.uniform(bcs.Neumann(), 2)
    for corners in (True, False):
        a = bcs.apply_bc(u, grid, nav0, 1, corners=corners)
        b = bcs.apply_bc(u, grid, diri, 1, corners=corners)
        assert float((a - b).abs().max()) < 1e-12
        c = bcs.apply_bc(u, grid, navinf, 1, corners=corners)
        d = bcs.apply_bc(u, grid, neum, 1, corners=corners)
        assert float((c - d).abs().max()) < 1e-9
    lam = 0.05
    e = bcs.apply_bc(u, grid, bcs.FieldBC.uniform(bcs.Navier(lam), 2), 1)
    ratio = (2 * lam - grid.h) / (2 * lam + grid.h)
    assert abs(float(e[0, 5] / e[1, 5]) - ratio) < 1e-12


def test_event_sum_and_filter():
    s = _sim()
    es = ev.EventSum("Pt", "P")
    s.state["P"] = torch.ones(s.cfg.grid.shape, dtype=F64)
    for t, i in ((0.0, 0), (0.5, 1), (1.5, 2)):
        s.time.t = t
        es.fire(s, t, i)
    assert float((s.state["Pt"] - 1.5).abs().max()) < 1e-12
    s.state["Q"] = torch.ones(s.cfg.grid.shape, dtype=F64)
    ev.EventFilter("Q").fire(s, 0.0, 0)
    assert float((s.state["Q"] - 1.0).abs().max()) < 1e-12


def test_event_harmonic_recovers_amplitudes():
    s = _sim(level=3)
    w = 2.0
    eh = ev.EventHarmonic("P", [w])
    for k in range(24):
        t = 0.3 * k
        s.time.t = t
        s.state["P"] = (1.5 + 2.0 * math.sin(w * t)
                        - 0.7 * math.cos(w * t)) * torch.ones((8, 8),
                                                              dtype=F64)
        eh.fire(s, t, k)
    assert abs(float(torch.mean(s.state["PZ"])) - 1.5) < 1e-8
    assert abs(float(torch.mean(s.state["PA0"])) - 2.0) < 1e-8
    assert abs(float(torch.mean(s.state["PB0"])) - (-0.7)) < 1e-8


def test_event_script(tmp_path):
    s = _sim(level=3)
    out = tmp_path / "es.txt"
    sc = ev.EventScript(f'echo "$GFS_I $GFS_T" >> {out}')
    s.time.t = 0.25
    s.time.i = 3
    sc.fire(s, 0.25, 3)
    assert out.read_text().strip() == "3 0.25"
    assert sc.returncodes == [0]


def test_remove_droplets_event():
    s = _sim(level=6, vof_tracer=True)
    grid = s.cfg.grid

    def phi(x, y):
        big = 0.2 - torch.sqrt((x + 0.2) ** 2 + y ** 2)
        tiny = 0.02 - torch.sqrt((x - 0.3) ** 2 + (y - 0.3) ** 2)
        return torch.maximum(big, tiny)

    s.state["T"] = vof.fraction_from_levelset(grid, phi, device="cpu")
    vol0 = float(torch.sum(s.state["T"]))
    ev.RemoveDroplets("T", min_cells=20).fire(s, 0.0, 0)
    vol1 = float(torch.sum(s.state["T"]))
    assert vol1 < vol0
    x, y = _centres(grid)
    tiny_region = torch.sqrt((x - 0.3) ** 2 + (y - 0.3) ** 2) < 0.05
    assert float(torch.sum(torch.where(tiny_region, s.state["T"], 0.0))) \
        < 1e-12
    big_region = torch.sqrt((x + 0.2) ** 2 + y ** 2) < 0.15
    assert float(torch.sum(torch.where(big_region, s.state["T"], 0.0))) \
        > 10.0


def test_init_vorticity():
    grid = Grid(level=6, dim=2)
    x, y = _centres(grid)
    om = torch.exp(-((x / 0.1) ** 2 + (y / 0.1) ** 2))
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    # a dense coarsest level of at most 1024 unknowns, as the JAX CPU path
    # caps it (a 64^2 level's 4096 unknowns take an eigh on the host)
    U, V = ev.init_vorticity(om, grid, None, MultilevelParams(
        tolerance=1e-9, nitermax=60, dense_coarse_max=1024))
    h = grid.h
    curl = ((V[2:, 1:-1] - V[:-2, 1:-1]) - (U[1:-1, 2:] - U[1:-1, :-2])) \
        / (2 * h)
    err = (curl - om[1:-1, 1:-1]).abs()
    interior = (x[1:-1, 1:-1].abs() < 0.3) & (y[1:-1, 1:-1].abs() < 0.3)
    rel = float(torch.max(torch.where(interior, err, 0.0)))
    assert rel < 0.02 * float(torch.max(om)), rel


def test_variable_laplacian_and_poisson():
    sim = _sim(level=6)
    x, y = _centres(sim.cfg.grid)
    f = torch.cos(2 * math.pi * x) * torch.cos(2 * math.pi * y)
    sim.state["F"] = f
    ev.VariableLaplacian("LapF", "F").fire(sim, 0.0, 0)
    lap = sim.state["LapF"]
    e = lap[2:-2, 2:-2] / (-8 * math.pi ** 2) - f[2:-2, 2:-2]
    assert float(e.abs().max()) < 2e-2
    from gerris_tpu_torch.solvers.poisson import MultilevelParams
    vp = ev.VariablePoisson("Back", "LapF", params=MultilevelParams(
        dense_coarse_max=1024))
    vp.fire(sim, 0.0, 0)
    err = sim.state["Back"] - (f - torch.mean(f))
    assert float(err.abs().max()) < 5e-3, float(err.abs().max())


def test_output_maxima_progress_grd(tmp_path):
    from gerris_tpu_torch.events import outputs as out
    grid = Grid(level=4, dim=2)
    cfg = ns.NSConfig(grid=grid, u_bcs=(bcs.velocity_bc(0, 2),
                                        bcs.velocity_bc(1, 2)), nu=0.0)
    sim = Simulation(cfg, time=Time(iend=0, end=1.0), device="cpu").init()
    x, y = _centres(grid)
    sim.state["P"] = torch.exp(-20 * ((x - 0.2) ** 2 + y ** 2))
    mx = out.OutputScalarMaxima("P", n=3, file=str(tmp_path / "max.dat"))
    mx.fire(sim, 0.0, 0)
    t_, k, px, py, pz, v = mx.rows[0]
    assert abs(px - 0.2) < 2 * grid.h and abs(py) < 2 * grid.h
    assert v == max(r[-1] for r in mx.rows)
    out.OutputGrd("P", str(tmp_path / "p.grd")).fire(sim, 0.0, 0)
    lines = (tmp_path / "p.grd").read_text().splitlines()
    assert lines[0].split() == ["ncols", "16"]
    assert lines[4].split()[0] == "cellsize"
    data = np.array([[float(c) for c in ln.split()] for ln in lines[6:]])
    assert data.shape == (16, 16)
    F = sim.state["P"].numpy()
    assert np.allclose(data, F.T[::-1], atol=1e-5)
    out.OutputProgress(file=str(tmp_path / "prog.dat")).fire(sim, 0.0, 0)
    assert "% done" in (tmp_path / "prog.dat").read_text()


# --- tests/test_les.py ----------------------------------------------------

LES = """
1 0 GfsSimulation GfsBox GfsGEdge {{}} {{
    Refine {level}
    VariableTurbulentViscosity NUT 0.17 {extra}
    SourceViscosity (0.001 + NUT)
    Init {{}} {{
        U = sin(2.*M_PI*y)
        V = sin(2.*M_PI*x)
    }}
    Time {{ iend = 2 }}
}}
GfsBox {{}}
"""


def _mk(level=5, extra="", dtype=F64):
    return G.build_simulation(G.parse_gfs(LES.format(level=level,
                                                     extra=extra), {},
                                          strict=True), device="cpu",
                              dtype=dtype)


def test_smagorinsky_formula():
    sim = _mk()
    sim.do_events()
    g = sim.cfg.grid
    h = g.h
    x, y = np.broadcast_arrays(*g.centers)
    dudy = 2 * math.pi * np.cos(2 * math.pi * y)
    dvdx = 2 * math.pi * np.cos(2 * math.pi * x)
    s12 = 0.5 * (dudy + dvdx)
    smag = (0.17 * h) ** 2 * np.sqrt(2.0 * (2 * s12 ** 2))
    got = sim.state["NUT"].numpy()
    err = np.abs(got[2:-2, 2:-2] - smag[2:-2, 2:-2])
    assert err.max() < 0.05 * smag.max(), err.max()
    assert got.min() >= 0.0


def test_sigma_vanishes_2d():
    sim = _mk(extra="sigma")
    sim.do_events()
    assert float(sim.state["NUT"].abs().max()) < 1e-10


def test_les_runs_into_diffusion():
    sim = _mk()
    sim.run()
    nut = sim.state["NUT"]
    assert torch.isfinite(sim.state["U"]).all()
    assert float(nut.max()) > 1e-6
    assert sim.cfg.nu_var is not None


def test_parse_cs_value():
    sim = _mk()
    evs = [e for e in sim.events
           if type(e).__name__ == "VariableTurbulentViscosity"]
    assert len(evs) == 1 and evs[0].cs == pytest.approx(0.17)


@pytest.mark.parametrize("model,dim", [("smagorinsky", 2), ("sigma", 3)])
def test_turbulent_viscosity_matches_the_jax_event(model, dim):
    """The port's nu_t of a random velocity equals the JAX event's: the
    Smagorinsky model in 2D, the sigma model's closed forms in 3D (in 2D
    its nu_t is roundoff: the third singular value vanishes)."""
    from gerris_tpu.core import bc as jbc
    from gerris_tpu.core.grid import Grid as JGrid
    from gerris_tpu.models import ns as jns
    from gerris_tpu.models.simulation import Simulation as JSim
    from gerris_tpu.models.simulation import Time as JTime
    level = 4 if dim == 2 else 3
    n = 1 << level
    names = ns.velocity_names(dim)
    rng = np.random.default_rng(5)
    fields = rng.standard_normal((dim,) + (n,) * dim)
    grid = Grid(level=level, dim=dim)
    sim = Simulation(ns.NSConfig(grid=grid, u_bcs=tuple(
        bcs.velocity_bc(c, dim) for c in range(dim))), time=Time(iend=0),
        device="cpu").init()
    js = JSim(jns.NSConfig(grid=JGrid(level=level, dim=dim), u_bcs=tuple(
        jbc.velocity_bc(c, dim) for c in range(dim))),
        time=JTime(iend=0)).init()
    for c, nm in enumerate(names):
        sim.state[nm] = torch.as_tensor(fields[c])
        js.state[nm] = jnp.asarray(fields[c])
    ev.VariableTurbulentViscosity("NUT", 0.17, model).fire(sim, 0.0, 0)
    jvar.VariableTurbulentViscosity("NUT", 0.17, model).fire(js, 0.0, 0)
    ref = np.asarray(js.state["NUT"])
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(sim.state["NUT"].numpy(), ref, rtol=1e-11,
                               atol=1e-12 * np.abs(ref).max())


def test_position_and_laplacian_match_the_jax_events():
    from gerris_tpu.core import bc as jbc
    from gerris_tpu.core.grid import Grid as JGrid
    from gerris_tpu.models import ns as jns
    from gerris_tpu.models.simulation import Simulation as JSim
    from gerris_tpu.models.simulation import Time as JTime
    sim = _sim(level=5, vof_tracer=True)
    sim.state["T"] = vof.fraction_from_levelset(
        sim.cfg.grid, lambda x, y: 0.3 - torch.sqrt(x ** 2 + y ** 2),
        device="cpu")
    jg = JGrid(level=5, dim=2)
    js = JSim(jns.NSConfig(grid=jg, u_bcs=(jbc.velocity_bc(0, 2),
                                           jbc.velocity_bc(1, 2)),
                           vof_tracers=(("T", jbc.default_scalar_bc(2)),)),
              time=JTime(iend=0)).init()
    js.state["T"] = jnp.asarray(sim.state["T"].numpy())
    for k in (0, 1):
        ev.VariablePosition("X", "T", k).fire(sim, 0.0, 0)
        jvar.VariablePosition("X", "T", k).fire(js, 0.0, 0)
        np.testing.assert_allclose(sim.state["X"].numpy(),
                                   np.asarray(js.state["X"]), rtol=1e-12,
                                   atol=1e-14)
    ev.VariableLaplacian("L", "T").fire(sim, 0.0, 0)
    jvar.VariableLaplacian("L", "T").fire(js, 0.0, 0)
    np.testing.assert_allclose(sim.state["L"].numpy(),
                               np.asarray(js.state["L"]), rtol=1e-12,
                               atol=1e-12)


# --- tests/test_misc2.py's variables ---------------------------------------

def test_variable_average_and_function():
    sim = _sim()
    av = ev.VariableAverage("Pm", "P")
    fn = ev.VariableFunction("Q", lambda s: s.state["P"] + 1.0)
    for k in range(3):
        sim.state["P"] = torch.full(sim.cfg.grid.shape, float(k), dtype=F64)
        av.fire(sim, 0.0, k)
        fn.fire(sim, 0.0, k)
    assert float((sim.state["Pm"] - 1.0).abs().max()) < 1e-12
    assert float((sim.state["Q"] - 3.0).abs().max()) < 1e-12


def test_variable_position_distance():
    sim = _sim(level=6, vof_tracer=True)
    sim.state["T"] = vof.fraction_from_levelset(
        sim.cfg.grid, lambda x, y: 0.3 - torch.sqrt(x ** 2 + y ** 2),
        device="cpu")
    for e in (ev.VariablePosition("Px", "T", 0),
              ev.VariablePosition("Py", "T", 1), ev.VariableDistance("D", "T")):
        e.fire(sim, 0.0, 0)
    X = sim.state["Px"].numpy()
    Y = sim.state["Py"].numpy()
    ifc = X < 1e29
    r = np.hypot(X[ifc], Y[ifc])
    assert ifc.sum() > 50
    assert np.abs(r - 0.3).max() < 1.5 * sim.cfg.grid.h
    D = sim.state["D"].numpy()
    x, y = np.broadcast_arrays(*sim.cfg.grid.centers)
    rr = np.hypot(x, y)
    inside, outside = rr < 0.2, rr > 0.4
    assert (D[inside] > 0).all() and (D[outside] < 0).all()
    err = np.abs(np.abs(D) - np.abs(0.3 - rr))
    assert err[inside | outside].max() < 2 * sim.cfg.grid.h


def test_variable_age_tracer_source():
    grid = Grid(level=4, dim=2)
    fbc = bcs.default_scalar_bc(2)
    cfg = ns.NSConfig(grid=grid, u_bcs=(bcs.velocity_bc(0, 2),
                                        bcs.velocity_bc(1, 2)),
                      nu=0.0, tracers=(("Age", fbc, 0.0, 1.0),))
    sim = Simulation(cfg, time=Time(iend=0), device="cpu").init()
    uf = [torch.zeros(grid.face_shape(c), dtype=F64) for c in range(2)]
    A = sim.state["Age"]
    for _ in range(2):
        A = ns.advect_tracer(A, cfg.tracers[0], uf, grid, cfg, 0.25, 0.0)
    assert float((A - 0.5).abs().max()) < 1e-12


# --- EventStop, the faults --------------------------------------------------

def test_event_stop_on_a_derived_variable_with_its_diff_field():
    """EventStop reads a derived variable through outputs.sim_field and
    stores the per-cell change as a field (EventStop Velocity 1e-12 DU)."""
    text = LES.format(level=4, extra="").replace(
        "Time {", "EventStop { istep = 1 } Velocity 1e-12 DU\n    Time {")
    sim = G.build_simulation(G.parse_gfs(text), device="cpu")
    stop = [e for e in sim.events if isinstance(e, EventStop)][0]
    assert stop.diff_name == "DU"
    sim.run()
    assert sim.state["DU"].shape == sim.state["U"].shape
    assert float(sim.state["DU"].max()) == sim.diagnostics["DU"] > 0


def test_amr_turbulent_viscosity_is_a_level_stack():
    """The JAX event stores nu_t flat on an AMRSimulation: its guard asks
    for sim.restrict_stack, which no simulation has (variables.py:128-131),
    and the composite step then indexes the flat field by level, i.e.
    takes its rows.  The port stores the level stack, the coarser levels
    the restrictions of the finest."""
    from gerris_tpu_torch.models import amr_ns
    from gerris_tpu_torch.solvers import poisson
    from gerris_tpu_torch.solvers.composite import CompositeGrid
    grid = Grid(level=4, dim=2)
    cfg = ns.NSConfig(grid=grid, u_bcs=(bcs.velocity_bc(0, 2),
                                        bcs.velocity_bc(1, 2)))
    mesh = CompositeGrid.from_refine_fn(Grid(level=3, dim=2), 4,
                                        lambda x, y, l: x < 0)
    sim = amr_ns.AMRSimulation(cfg, mesh=mesh, device="cpu")
    sim.init(U=lambda x, y: np.sin(2 * np.pi * y),
             V=lambda x, y: np.sin(2 * np.pi * x))
    ev.VariableTurbulentViscosity("NUT", 0.17).fire(sim, 0.0, 0)
    st = sim.state["NUT"]
    assert sorted(st) == [3, 4]
    assert torch.equal(st[3], poisson.restrict(st[4]))
    assert not hasattr(sim, "restrict_stack")


def test_guards_are_the_dtype_tiny():
    """The reference's tensor guards of 1e-300 (variables.py:113-125) are
    0 in float32: the port's sigma model guards with the dtype's tiny and
    gives a finite nu_t in float32 where the invariants vanish."""
    for dt in (torch.float32, torch.float64):
        sim = _sim(level=4, dtype=dt)
        ev.VariableTurbulentViscosity("NUT", 0.17, "sigma").fire(sim, 0.0, 0)
        assert torch.isfinite(sim.state["NUT"]).all()
        assert ev._tiny(sim.state["U"]) == torch.finfo(dt).tiny
    # 1e-300 in float32 is 0: the reference's guard would divide by it
    assert torch.tensor(1e-300, dtype=torch.float32).item() == 0.0
