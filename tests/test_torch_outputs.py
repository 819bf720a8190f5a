"""The port's output events (gerris_tpu_torch/events/outputs.py) with the
assertions of tests/test_outputs.py and tests/test_outputs2.py, on the
CPU in float64, and the outputs against the JAX package's on the same
field: the norms, sums, error norms and correlation rows, the raster
and the facets.  An output reads the device only on the step it fires."""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.events import outputs as jout  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.models.simulation import Simulation as JSim  # noqa: E402
from gerris_tpu.models.simulation import Time as JTime  # noqa: E402

from gerris_tpu_torch.core import bc as bcs  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.events import outputs as out  # noqa: E402
from gerris_tpu_torch.models import ns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.physics import droplets, vof  # noqa: E402

CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def tg_sim(level=4, t_end=0.1):
    grid = Grid(level=level, dim=2)
    per = bcs.FieldBC.uniform(bcs.Periodic(), 2)
    cfg = ns.NSConfig(grid=grid, u_bcs=(per, per), nu=0.01)
    x, y = np.broadcast_arrays(*grid.centers)
    sim = Simulation(cfg, time=Time(end=t_end, dtmax=0.5 * grid.h),
                     device="cpu")
    sim.init(U=-np.cos(2 * math.pi * x) * np.sin(2 * math.pi * y),
             V=np.sin(2 * math.pi * x) * np.cos(2 * math.pi * y))
    return sim


def _walls_sim(level, **kw):
    grid = Grid(level=level, dim=2)
    cfg = ns.NSConfig(grid=grid, u_bcs=(bcs.velocity_bc(0, 2),
                                        bcs.velocity_bc(1, 2)), nu=0.0, **kw)
    return Simulation(cfg, time=Time(iend=0), device="cpu").init()


# --- tests/test_outputs.py ------------------------------------------------

def test_checkpoint_resume(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    sim = tg_sim(t_end=0.2)
    sim.run(max_steps=5)
    out.save_checkpoint(path, sim)
    sim.run(max_steps=5)
    u_direct = sim.state["U"].clone()
    i_direct = sim.time.i
    sim2 = tg_sim(t_end=0.2)
    out.load_checkpoint(path, sim2)
    sim2.run(max_steps=5)
    assert sim2.time.i == i_direct
    assert float((sim2.state["U"] - u_direct).abs().max()) < 1e-14


def test_output_events(tmp_path):
    sim = tg_sim(t_end=0.05)
    norm_file = str(tmp_path / "norm.txt")
    loc_file = str(tmp_path / "loc.txt")
    ppm_file = str(tmp_path / "f.ppm")
    enorm = out.OutputScalarNorm("U", file=norm_file, istep=2)
    eloc = out.OutputLocation(["U", "V"], [(0.1, 0.2), (0.0, 0.0)],
                              file=loc_file, istep=2)
    sim.events += [enorm, eloc, out.OutputTiming(file=str(tmp_path / "t.txt"),
                                                 start="end")]
    sim.run()
    assert len(enorm.rows) >= 2
    assert os.path.getsize(norm_file) > 0
    assert len(eloc.rows) >= 4
    out.write_ppm(ppm_file, sim.state["U"])
    with open(ppm_file, "rb") as f:
        assert f.read(2) == b"P6"
    assert "step" in open(str(tmp_path / "t.txt")).read()


def test_steps_are_timed_only_under_output_timing(tmp_path):
    """The step timer runs only in a run with an OutputTiming event,
    which reads it; a run without one steps untimed."""
    sim = tg_sim(t_end=1.0)
    sim.run(max_steps=3)
    assert sim.step_timer[1] == 0 and sim.timer_totals() == {}
    sim.events.append(out.OutputTiming(file=str(tmp_path / "t.txt"),
                                       start="end"))
    sim.run(max_steps=2)
    seconds, steps = sim.timer_totals()["step"]
    assert steps == 2 and seconds > 0.0


def test_error_norm_event():
    sim = tg_sim(t_end=0.02)
    nu = 0.01

    def exact(x, y, t):
        return -torch.cos(2 * math.pi * x) * torch.sin(2 * math.pi * y) * \
            math.exp(-8 * math.pi ** 2 * nu * t)

    ev = out.OutputErrorNorm("U", exact, istep=1)
    sim.events.append(ev)
    sim.run()
    assert ev.rows[-1][3] < 0.05


def test_droplet_tagging_and_conversion():
    grid = Grid(level=6, dim=2)

    def fr(phi):
        return vof.fraction_from_levelset(grid, phi, device="cpu")
    f = (fr(lambda x, y: 0.15 ** 2 - x * x - y * y)
         + fr(lambda x, y: 0.02 ** 2 - (x - 0.35) ** 2 - (y - 0.35) ** 2)
         + fr(lambda x, y: 0.015 ** 2 - (x + 0.3) ** 2 - (y - 0.3) ** 2))
    labels, n = droplets.tag_droplets(f)
    assert n == 3
    U = [torch.ones(grid.shape, dtype=torch.float64),
         torch.zeros(grid.shape, dtype=torch.float64)]
    f2, plist = droplets.droplets_to_particles(f, U, grid, min_cells=30)
    assert plist["pos"].shape[0] == 2
    _, n2 = droplets.tag_droplets(f2)
    assert n2 == 1
    assert torch.all((plist["vel"][:, 0] - 1.0).abs() < 1e-12)
    assert torch.all(plist["vol"] > 0)
    f3 = droplets.particle_to_droplet(f2, plist["pos"][0], plist["vol"][0],
                                      grid)
    _, n3 = droplets.tag_droplets(f3)
    assert n3 == 2
    vol = float(plist["vol"][0])
    vol_err = abs(float(torch.sum(f3) - torch.sum(f2)) * grid.cell_volume
                  - vol) / vol
    assert vol_err < 0.05


def test_projection_stats_and_droplet_sums():
    sim = tg_sim(t_end=0.03)
    ps = out.OutputProjectionStats(istep=2, file="/dev/null")
    sim.events.append(ps)
    sim.run()
    assert len(ps.rows) >= 1
    assert ps.rows[-1][3] < 10.0
    grid = sim.cfg.grid
    f = (vof.fraction_from_levelset(
        grid, lambda x, y: 0.1 ** 2 - x * x - y * y, device="cpu")
        + vof.fraction_from_levelset(
            grid, lambda x, y: 0.05 ** 2 - (x - 0.3) ** 2 - (y - 0.3) ** 2,
            device="cpu"))
    sim.state["T"] = f
    ev = out.OutputDropletSums("T", istep=1)
    ev.fire(sim, sim.time.t, sim.time.i)
    assert len(ev.rows) == 2
    vols = sorted(r[2] for r in ev.rows)
    assert abs(vols[1] - math.pi * 0.01) / (math.pi * 0.01) < 0.2


# --- tests/test_outputs2.py -----------------------------------------------

class _FakeSim:
    def __init__(self, i, t):
        class T:
            pass
        self.time = T()
        self.time.i = i
        self.time.t = t


def test_format_filename():
    s = _FakeSim(42, 1.25)
    assert out.format_filename("sim-%ld.dat", s) == "sim-42.dat"
    assert out.format_filename("sim-%09d.gfs", s) == "sim-000000042.gfs"
    assert out.format_filename("t-%g.dat", s) == "t-1.25.dat"
    assert out.format_filename("plain.dat", s) == "plain.dat"
    assert out.format_filename(None, s) is None


def test_solid_force_archimedes():
    R = 0.2
    c = 3.0
    sim = _walls_sim(7, solid_phi=lambda x, y: torch.sqrt(x ** 2 + y ** 2)
                     - R)
    x, y = np.broadcast_arrays(*sim.cfg.grid.centers)
    sim.state["P"] = _t(c * y)
    sim.dt = 1.0
    ev = out.OutputSolidForce()
    ev.fire(sim, 0.0, 0)
    t_, fpx, fpy, fvx, fvy, mp, mv = ev.rows[0]
    exact = -c * math.pi * R ** 2
    assert abs(fpx) < 0.02 * abs(exact), fpx
    assert abs(fpy - exact) / abs(exact) < 0.05, (fpy, exact)


def test_scalar_histogram():
    sim = _walls_sim(5)
    x, _ = np.broadcast_arrays(*sim.cfg.grid.centers)
    sim.state["P"] = _t(x)
    ev = out.OutputScalarHistogram("P", n=8, vmin=-0.5, vmax=0.5,
                                   y=lambda s: 2.0 * s.state["P"])
    ev.fire(sim, 0.0, 0)
    counts = ev.last[:, 1]
    assert np.all(counts == counts[0])
    assert np.allclose(ev.last[:, 2], 2.0 * ev.last[:, 0], atol=0.05)


def test_interface_facets_circle():
    R = 0.3
    grid = Grid(level=6, dim=2)
    T = vof.fraction_from_levelset(
        grid, lambda x, y: R - torch.sqrt(x ** 2 + y ** 2), device="cpu")
    segs = vof.facets(T, grid, bcs.default_scalar_bc(2))
    assert segs.shape[0] > 100
    for px, py in ((segs[:, 0], segs[:, 1]), (segs[:, 2], segs[:, 3])):
        r = np.sqrt(px ** 2 + py ** 2)
        assert np.max(np.abs(r - R)) < 1.5 * grid.h
    L = float(np.sum(np.hypot(segs[:, 2] - segs[:, 0],
                              segs[:, 3] - segs[:, 1])))
    assert abs(L - 2 * math.pi * R) / (2 * math.pi * R) < 0.02, L
    # the same segments as the JAX package's facets of the same fraction
    from gerris_tpu.physics import vof as jvof
    jsegs = jvof.facets(jnp.asarray(T.numpy()), JGrid(level=6, dim=2),
                        jbc.default_scalar_bc(2))
    assert jsegs.shape == segs.shape
    assert np.abs(jsegs - segs).max() < 1e-12


def test_correlation_and_squares(tmp_path):
    sim = _walls_sim(5)
    x, _ = np.broadcast_arrays(*sim.cfg.grid.centers)
    ref = np.cos(2 * np.pi * x)
    sim.state["P"] = _t(0.7 * ref + 0.1)
    ev = out.OutputCorrelation("P", lambda x, y: torch.cos(2 * np.pi * x))
    ev.fire(sim, 0.0, 0)
    assert abs(ev.rows[0][1] - 0.7) < 1e-6
    ev2 = out.OutputCorrelation("P", lambda x, y: torch.cos(2 * np.pi * x),
                                unbiased=True)
    ev2.fire(sim, 0.0, 0)
    assert abs(ev2.rows[0][1] - 0.7) < 1e-6
    p = tmp_path / "sq.oogl"
    out.OutputSquares("P", str(p)).fire(sim, 0.0, 0)
    txt = p.read_text()
    assert txt.splitlines()[0].strip().startswith("LIST") or "QUAD" in txt


def test_parser_wires_new_outputs(tmp_path):
    from gerris_tpu_torch.utils import gfs_config as G
    gfs = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 0 }
  VariableTracer T
  Init {} { T = cos(2.*M_PI*y) }
  OutputCorrelation { istep = 1 } %s { v = T } { s = cos(2.*M_PI*y) }
  OutputSquares { istep = 1 } %s { v = T min = -1 max = 1 }
  OutputLocation { istep = 1 } %s 0.25 0.25
}
GfsBox {}
""" % (tmp_path / "corr.dat", tmp_path / "sq-%ld.oogl",
       tmp_path / "loc.dat")
    ps = G.parse_gfs(gfs, {})
    sim = G.build_simulation(ps, device="cpu")
    assert not ps.errors, ps.errors
    kinds = {type(e).__name__ for e in sim.events}
    assert {"OutputCorrelation", "OutputSquares",
            "OutputLocation"} <= kinds, kinds
    sim.run()
    corr = (tmp_path / "corr.dat").read_text()
    assert abs(float(corr.split()[-1]) - 1.0) < 1e-3, corr
    assert (tmp_path / "sq-0.oogl").exists()
    loc = (tmp_path / "loc.dat").read_text().strip().splitlines()
    assert len(loc) >= 1 and len(loc[0].split()) >= 5, loc


def test_adapt_stats_and_boundaries(tmp_path):
    R = 0.25
    sim = _walls_sim(5, solid_phi=lambda x, y: torch.sqrt(x ** 2 + y ** 2)
                     - R)
    st = out.OutputAdaptStats(file=str(tmp_path / "as.dat"))
    st.fire(sim, 0.0, 0)
    txt = (tmp_path / "as.dat").read_text()
    assert "Number of cells" in txt and st.counts == [1024]
    assert "Compression vs uniform: 1.000" in txt
    ob = out.OutputBoundaries(str(tmp_path / "b.dat"))
    ob.fire(sim, 0.0, 0)
    segs = [ln.split() for ln in
            (tmp_path / "b.dat").read_text().splitlines() if ln.strip()]
    pts = np.array([[float(a), float(b)] for a, b in segs])
    assert pts[:8].min() == -0.5 and pts[:8].max() == 0.5
    r = np.hypot(pts[8:, 0], pts[8:, 1])
    assert len(r) > 50 and np.abs(r - R).max() < 2 * sim.cfg.grid.h


# --- the outputs against the JAX package's on the same fields -------------

def _pair(level=5):
    """A port and a JAX simulation at rest with the same random fields."""
    rng = np.random.default_rng(3)
    fields = {n: rng.standard_normal((1 << level, 1 << level))
              for n in ("U", "V", "P")}
    tsim = _walls_sim(level)
    jg = JGrid(level=level, dim=2)
    jsim = JSim(jns.NSConfig(grid=jg, u_bcs=(jbc.velocity_bc(0, 2),
                                             jbc.velocity_bc(1, 2)), nu=0.0),
                time=JTime(iend=0)).init()
    for n, a in fields.items():
        tsim.state[n] = _t(a)
        jsim.state[n] = jnp.asarray(a)
    return tsim, jsim


def test_rows_match_the_jax_outputs():
    tsim, jsim = _pair()
    sol_t = lambda x, y, t: torch.sin(3 * x) * torch.cos(y) + t  # noqa
    sol_j = lambda x, y, t: jnp.sin(3 * x) * jnp.cos(y) + t  # noqa
    pairs = [
        (out.OutputScalarNorm("U"), jout.OutputScalarNorm("U")),
        (out.OutputScalarNorm("Velocity"), jout.OutputScalarNorm("Velocity")),
        (out.OutputScalarNorm("Vorticity"),
         jout.OutputScalarNorm("Vorticity")),
        (out.OutputScalarNorm("Divergence"),
         jout.OutputScalarNorm("Divergence")),
        (out.OutputScalarSum("P"), jout.OutputScalarSum("P")),
        (out.OutputErrorNorm("P", sol_t, unbiased=True, relative=True),
         jout.OutputErrorNorm("P", sol_j, unbiased=True, relative=True)),
        (out.OutputCorrelation("P", sol_t, unbiased=True),
         jout.OutputCorrelation("P", sol_j, unbiased=True)),
        (out.OutputProjectionStats(file="/dev/null"),
         jout.OutputProjectionStats(file="/dev/null")),
    ]
    for pe, je in pairs:
        pe.fire(tsim, 0.0, 0)
        je.fire(jsim, 0.0, 0)
        np.testing.assert_allclose(np.asarray(pe.rows[0], float),
                                   np.asarray(je.rows[0], float),
                                   rtol=1e-12, atol=1e-13, err_msg=pe.name)


def test_ppm_and_grd_match_the_jax_outputs(tmp_path):
    tsim, jsim = _pair(4)
    out.write_ppm(str(tmp_path / "a.ppm"), tsim.state["P"])
    jout.write_ppm(str(tmp_path / "b.ppm"), np.asarray(jsim.state["P"]))
    assert (tmp_path / "a.ppm").read_bytes() == \
        (tmp_path / "b.ppm").read_bytes()
    out.OutputGrd("P", str(tmp_path / "a.grd")).fire(tsim, 0.0, 0)
    jout.OutputGrd("P", str(tmp_path / "b.grd")).fire(jsim, 0.0, 0)
    assert (tmp_path / "a.grd").read_text() == \
        (tmp_path / "b.grd").read_text()


def test_outputs_read_the_device_once_when_they_fire():
    """A norm's three numbers and the correlation's two sums come to the
    host in one read each (chip_smoke.count_syncs counts the tensor calls
    that would synchronise the card)."""
    import chip_smoke
    tsim, _ = _pair(4)
    ev = out.OutputScalarNorm("U")
    assert chip_smoke.count_syncs(lambda: ev.fire(tsim, 0.0, 0), "cpu")[0] == 1
    ev = out.OutputCorrelation("P", lambda x, y: x + y)
    assert chip_smoke.count_syncs(lambda: ev.fire(tsim, 0.0, 0), "cpu")[0] == 1


def test_error_norm_solution_sees_the_time():
    """A .gfs OutputErrorNorm solution that reads t sees the time: the
    JAX package calls the translated expression (x, y, t) by its
    argument count (outputs.py:168-170), which puts t in z's place, so
    its solution reads t = 0 in 2D."""
    from gerris_tpu.utils import gfs_config as J
    from gerris_tpu_torch.utils import gfs_config as G
    text = """1 0 GfsSimulation GfsBox GfsGEdge {} {
  Time { iend = 0 }
  Refine 3
  OutputErrorNorm { istep = 1 } /dev/null { v = P } { s = t }
}
GfsBox {}
"""
    tsim = G.build_simulation(G.parse_gfs(text), device="cpu")
    jsim = J.build_simulation(J.parse_gfs(text))
    for s in (tsim, jsim):
        s.time.t = 0.5
        s.events[0].fire(s, 0.5, 0)
    assert tsim.events[0].rows[0][3] == 0.5
    assert jsim.events[0].rows[0][3] == 0.0
