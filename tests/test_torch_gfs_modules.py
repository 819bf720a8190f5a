"""The fork's module classes and the 3D build through the port's .gfs
reader, on the CPU in float64, with the assertions of
tests/test_gfs_modules.py (GfsParticleList with its forces and
GfsOutputParticleList, modules/particulatecommon.c; GfsInitSpectra and
the spectra outputs, modules/fft.c and modules/turbulence.c) and of
tests/test_gfs_config.py::test_build_3d (the same file run by gerris3D,
src/ftt.h FTT_DIMENSION)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu_torch.utils import gfs_config as gc  # noqa: E402

from test_gfs_modules import FFT_GFS, PARTICULATE_GFS  # noqa: E402
from test_torch_gfs_reader import BUILD3D  # noqa: E402


def _build(parsed, cap=None, **kw):
    """The port's build on the CPU in float64; ``cap``: its solves' dense
    coarsest level capped at that many unknowns (a 64^2 or 16^3 level's
    4096 take a slow eigh on the host; the schedule is not what these
    gates check)."""
    import dataclasses
    s = gc.build_simulation(parsed, device="cpu", dtype=torch.float64, **kw)
    if cap:
        def c(p):
            return dataclasses.replace(p, dense_coarse_max=cap)
        s.cfg = dataclasses.replace(
            s.cfg, projection=c(s.cfg.projection),
            approx_projection=c(s.cfg.approx_projection),
            diffusion_params=c(s.cfg.diffusion_params))
    return s


def test_particle_list_gfs_runs_and_relaxes(tmp_path):
    pfile = str(tmp_path / "parts.txt")
    sim = gc.parse_gfs(PARTICULATE_GFS % pfile)
    assert len(sim.particle_lists) == 1
    pl = sim.particle_lists[0]
    assert pl["name"] == "cloud"
    assert len(pl["particles"]) == 2
    assert pl["particles"][0]["pos"][:2] == [-0.3, 0.05]
    assert pl["particles"][0]["mass"] == 0.002
    assert pl["forces"] == [("GfsForceDrag", "8.0")]
    assert pl["idlast"] == 2
    s = _build(sim)
    assert len(s.particle_systems) == 1
    psys = s.particle_systems[0]
    assert psys.name == "cloud"
    assert psys.pcfg.cd == 8.0
    s.run()
    vel = psys.state["vel"][:2].numpy()
    pos = psys.state["pos"][:2].numpy()
    assert (vel[:, 0] > 0.05).all(), vel
    assert (vel[:, 0] < 1.0 + 1e-6).all(), vel
    assert (pos[:, 0] > -0.3 + 1e-4).all(), pos
    assert os.path.exists(pfile)
    rows = [ln for ln in open(pfile).read().splitlines() if ln.strip()]
    assert len(rows) >= 4
    assert len(rows[0].split()) == 1 + 1 + 2 + 2


def test_particle_list_matches_python_api():
    """The .gfs-built particle run equals the same configuration driven
    through the Python API."""
    from gerris_tpu_torch.models.particle_system import ParticleSystem
    from gerris_tpu_torch.models.simulation import Simulation, Time
    from gerris_tpu_torch.physics import particles as parts
    s = _build(gc.parse_gfs(PARTICULATE_GFS % "/dev/null"))
    s.run()
    pcfg = parts.ParticleConfig(capacity=16, forces=("drag",), cd=8.0)
    st = parts.make_particles(
        16, 2, pos=[[-0.3, 0.05], [-0.3, -0.05]],
        vel=[[0.0, 0.0], [0.0, 0.0]], vol=[1e-5, 1e-5],
        mass=[0.002, 0.002], device="cpu")
    s2 = Simulation(s.cfg, time=Time(end=0.12), device="cpu",
                    particle_systems=[ParticleSystem(pcfg, st)])
    s2.init(U=lambda x, y: np.ones_like(x))
    s2.run()
    p1 = s.particle_systems[0].state["pos"][:2]
    p2 = s2.particle_systems[0].state["pos"][:2]
    assert float((p1 - p2).abs().max()) < 1e-10, (p1, p2)


def test_fft_gfs_init_and_output_spectra(tmp_path):
    f1 = str(tmp_path / "espec.txt")
    f2 = str(tmp_path / "uspec.txt")
    sim = gc.parse_gfs(FFT_GFS % (f1, f2))
    assert sim.init_spectra is not None
    assert sim.init_spectra["pos"]["E"] == "0.5"
    assert sim.init_spectra["vars"] == ["U", "V"]
    s = _build(sim, cap=1024)
    grid = s.cfg.grid
    U, V = s.state["U"], s.state["V"]
    ke = float(torch.sum(U ** 2 + V ** 2)) * grid.cell_volume / 2.0
    assert abs(ke - 0.5) < 1e-3, ke
    uh = torch.fft.fft2(U)
    vh = torch.fft.fft2(V)
    kx = torch.fft.fftfreq(grid.n, dtype=torch.float64)[:, None]
    ky = torch.fft.fftfreq(grid.n, dtype=torch.float64)[None, :]
    divh = float(torch.max(torch.abs(kx * uh + ky * vh)))
    mag = float(torch.max(torch.sqrt(kx ** 2 + ky ** 2)
                          * torch.sqrt(torch.abs(uh) ** 2
                                       + torch.abs(vh) ** 2)))
    assert divh < 1e-6 * max(mag, 1.0), (divh, mag)
    s.run(max_steps=2)
    assert os.path.exists(f1) and os.path.exists(f2)
    rows = [ln.split() for ln in open(f1).read().splitlines()
            if ln.strip() and not ln.startswith("#")]
    k = np.array([float(r[0]) for r in rows])
    E = np.array([float(r[1]) for r in rows])
    first = E[: len(E) // 2] if (k[1:] < k[:-1]).any() else E
    assert first.sum() > 0.0


def test_build_3d():
    ps = gc.parse_gfs(BUILD3D, {})
    sim = _build(ps, cap=512, dim=3)
    assert not ps.errors, ps.errors
    assert sim.cfg.grid.dim == 3 and sim.cfg.grid.shape == (16, 16, 16)
    T0 = sim.state["T"].numpy()
    assert T0.std(axis=2).max() > 1e-3
    mass0 = float(T0.sum())
    sim.run()
    T1 = sim.state["T"].numpy()
    assert np.isfinite(T1).all()
    assert abs(float(T1.sum()) - mass0) / mass0 < 1e-3
    assert sim.cfg.tracers[0][1].sides[2][1].kind == "dirichlet"
