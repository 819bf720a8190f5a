"""The port's graphics exports and debug layer (gerris_tpu_torch/events/
graphics.py, utils/debug.py) with the assertions of tests/test_misc2.py
(test_vtk_and_isolines, test_streamlines_rotation, test_pipe_sink,
test_debug_layer) on the CPU, and the exports byte for byte against the
JAX package's on the same fields."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.events import graphics as jgfx  # noqa: E402

from gerris_tpu_torch.core import bc as bcs  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.events import graphics as gfx  # noqa: E402
from gerris_tpu_torch.models import ns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.utils import debug  # noqa: E402


def _xy(grid):
    return [torch.as_tensor(c) for c in np.broadcast_arrays(*grid.centers)]


def test_vtk_and_isolines(tmp_path):
    grid = Grid(level=5, dim=2)
    x, y = _xy(grid)
    f = torch.sqrt(x ** 2 + y ** 2)
    path = tmp_path / "out.vtk"
    gfx.write_vtk(str(path), grid, {"r": f}, {"vel": (x, y)})
    text = path.read_text()
    assert "STRUCTURED_POINTS" in text and "SCALARS r" in text
    assert "VECTORS vel" in text
    segs = gfx.isolines(f, grid, 0.25)
    L = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1]).sum()
    assert abs(L - 2 * math.pi * 0.25) / (2 * math.pi * 0.25) < 0.02
    # byte for byte the JAX package's file, and its segments
    jpath = tmp_path / "jax.vtk"
    jgfx.write_vtk(str(jpath), JGrid(level=5, dim=2), {"r": f.numpy()},
                   {"vel": (x.numpy(), y.numpy())})
    assert jpath.read_text() == text
    assert np.array_equal(jgfx.isolines(f.numpy(), JGrid(level=5, dim=2),
                                        0.25), segs)


def test_streamlines_rotation():
    grid = Grid(level=6, dim=2)
    x, y = _xy(grid)
    lines = gfx.streamlines(-y, x, grid, [(0.3, 0.0)], ds=0.01,
                            max_steps=300, both=False)
    r = np.hypot(lines[0][:, 0], lines[0][:, 1])
    assert len(lines[0]) > 100
    assert np.abs(r - 0.3).max() < 0.01, np.abs(r - 0.3).max()
    jl = jgfx.streamlines(-y.numpy(), x.numpy(), JGrid(level=6, dim=2),
                          [(0.3, 0.0)], ds=0.01, max_steps=300, both=False)
    assert np.array_equal(jl[0], lines[0])


def test_pipe_sink(tmp_path):
    out = tmp_path / "piped.txt"
    fp, close = gfx.open_sink("{ cat > %s }" % out)
    fp.write("hello pipe\n")
    close()
    assert out.read_text() == "hello pipe\n"


def test_squares_and_oogl_match_the_jax_files(tmp_path):
    grid = Grid(level=3, dim=2)
    f = torch.as_tensor(np.random.default_rng(2).standard_normal((8, 8)))
    gfx.write_gnuplot_squares(str(tmp_path / "a.sq"), grid, f)
    jgfx.write_gnuplot_squares(str(tmp_path / "b.sq"), JGrid(level=3, dim=2),
                               f.numpy())
    gfx.write_oogl(str(tmp_path / "a.oogl"), grid, f, vmin=-1.0)
    jgfx.write_oogl(str(tmp_path / "b.oogl"), JGrid(level=3, dim=2),
                    f.numpy(), vmin=-1.0)
    for a, b in (("a.sq", "b.sq"), ("a.oogl", "b.oogl")):
        assert (tmp_path / a).read_text() == (tmp_path / b).read_text()


def _walls_sim(**kw):
    cfg = ns.NSConfig(grid=Grid(level=4, dim=2),
                      u_bcs=(bcs.velocity_bc(0, 2), bcs.velocity_bc(1, 2)),
                      nu=1e-2)
    return Simulation(cfg, time=Time(iend=2, dtmax=0.05), device="cpu", **kw)


def test_debug_layer():
    """catch_fpe raises on a non-finite value; check_state flags the
    reference's invariants (utils.c FPE traps, solid.c:990-1169 checks)."""
    with pytest.raises(FloatingPointError):
        with debug.catch_fpe() as watch:
            watch["x"] = torch.zeros(4) / torch.zeros(4)
    ok = {"U": torch.ones((4, 4)), "T": torch.full((4, 4), 0.5)}
    assert debug.check_state(ok) == []
    bad = {"U": torch.full((4, 4), math.nan), "T": torch.full((4, 4), 1.5)}
    msgs = debug.check_state(bad)
    assert len(msgs) == 2 and "non-finite" in msgs[0]
    with pytest.raises(AssertionError):
        debug.assert_consistent(bad)
    sim = _walls_sim(events=[debug.CheckEvent()])
    sim.init(U=lambda x, y: np.sin(2 * np.pi * y))
    sim.run()
    assert sim.time.i == 2


def test_catch_fpe_in_a_run():
    """catch_fpe(sim): a FloatingPointCheck event for the scope; a run that
    makes a NaN raises at the next firing, and the event leaves the
    simulation's events afterwards."""
    sim = _walls_sim()
    sim.init(U=lambda x, y: np.sin(2 * np.pi * y))
    with debug.catch_fpe(sim):
        sim.run()
    assert sim.events == []
    sim.state["V"] = sim.state["V"] / 0.0
    sim.time.iend = 3
    with pytest.raises(FloatingPointError, match="V"):
        with debug.catch_fpe(sim):
            sim.run()


def test_catch_fpe_reads_the_device_only_when_it_fires():
    """The check event reads the whole state in one read when it fires and
    nothing on the steps it does not (chip_smoke.count_syncs)."""
    import chip_smoke
    sim = _walls_sim()
    sim.init()
    check = debug.FloatingPointCheck(istep=2)
    check.should_fire(0.0, 0)
    assert chip_smoke.count_syncs(lambda: check.fire(sim, 0.0, 0),
                                  "cpu")[0] == 1
    assert not check.should_fire(0.1, 1)
