"""The port's build_simulation (gerris_tpu_torch/utils/gfs_config.py)
against the JAX package's on the same .gfs texts, on the CPU in float64.

* The configuration: the port's NSConfig equals utils/convert's
  config_from_jax of the JAX build's, field by field (the JAX callables'
  counterparts are the port's own closures), so the reader gives the
  schedule the TPU runs (params_from_jax's floors); GfsPoisson's params
  likewise.
* The runs: the lid, a VOF/tension text, a particle text, the FFT text
  of tests/test_gfs_modules.py, GfsPoisson, GfsAdvection and an AMR text
  at levels 4-5, built from their text and run for a few steps, held to
  the JAX package's runs of the same text with the same schedule, pinned
  by tools/jax_pins.py (JAX_PINS below), within 1e-10 of each field's
  maximum."""
import dataclasses
import math
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.utils import gfs_config as J  # noqa: E402

from gerris_tpu_torch.spectral import fft as tfft  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402
from gerris_tpu_torch.utils import gfs_config as G  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402
import test_gfs_modules as jmod  # noqa: E402
from test_torch_gfs_reader import (ADVECTION, AMR, LID, POISSON,  # noqa: E402
                                   VOF, LES)

CPU = torch.device("cpu")
RTOL = 1e-10
LID5 = LID.replace("LEVEL", "5").replace("DTMAX", "0.02")
PARTICULATE = jmod.PARTICULATE_GFS % "/dev/null"
FFT = jmod.FFT_GFS % ("/dev/null", "/dev/null")
TEXTS = {"lid": LID5, "vof": VOF, "particulate": PARTICULATE, "fft": FFT,
         "amr": AMR, "les": LES.format(level=4, extra="")}


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _port(text, cap=False):
    """The port's build on the CPU in float64; ``cap``: its solves' dense
    coarsest level capped at 1024 unknowns, as the JAX CPU path caps it
    (solvers/poisson.py; the card's schedule keeps 4096)."""
    s = _quiet(G.build_simulation, G.parse_gfs(text), device="cpu",
               dtype=torch.float64)
    if cap:
        def c(p):
            return dataclasses.replace(p, dense_coarse_max=1024)
        if hasattr(s, "cfg"):
            s.cfg = dataclasses.replace(
                s.cfg, projection=c(s.cfg.projection),
                approx_projection=c(s.cfg.approx_projection),
                diffusion_params=c(s.cfg.diffusion_params))
        else:
            s.params = c(s.params)
    return s


def _jax_params(p):
    """The port's schedule as the JAX package's MultilevelParams (the JAX
    run takes the floors explicitly: on the CPU it applies none)."""
    from gerris_tpu.solvers.poisson import MultilevelParams as JMP
    return JMP(**dataclasses.asdict(p))


def _jax(text, tsim):
    """The JAX build of ``text`` with the port's schedule."""
    js = _quiet(J.build_simulation, J.parse_gfs(text))
    if hasattr(js, "cfg"):
        tc = tsim.cfg
        js.cfg = dataclasses.replace(
            js.cfg, projection=_jax_params(tc.projection),
            approx_projection=_jax_params(tc.approx_projection),
            diffusion_params=_jax_params(tc.diffusion_params))
    elif hasattr(js, "params"):
        js.params = _jax_params(tsim.params)
    return js


def _counterparts(tc):
    """config_from_jax's torch counterparts: the port's own closures."""
    kw = dict(nu_var=tc.nu_var, solid_phi=tc.solid_phi,
              body_force=tc.body_force, surface_u=tc.surface_u)
    return {k: v for k, v in kw.items() if v is not None}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_config_is_config_from_jax_of_the_jax_build(name):
    tsim = _port(TEXTS[name])
    jsim = _quiet(J.build_simulation, J.parse_gfs(TEXTS[name]))
    want = convert.config_from_jax(jsim.cfg, **_counterparts(tsim.cfg))
    for f in dataclasses.fields(want):
        assert getattr(tsim.cfg, f.name) == getattr(want, f.name), f.name
    assert tsim.cfg == want
    assert (tsim.time.t, tsim.time.end, tsim.time.iend, tsim.time.dtmax) \
        == (jsim.time.t, jsim.time.end, jsim.time.iend, jsim.time.dtmax)
    assert [type(e).__name__ for e in jsim.events] == \
        [type(e).__name__ for e in tsim.events]


def test_poisson_params_are_params_from_jax():
    text = POISSON.replace("LEVEL", "5")
    tsim = _port(text)
    jsim = _quiet(J.build_simulation, J.parse_gfs(text))
    assert tsim.params == convert.params_from_jax(jsim.params, 2)
    assert tsim.p_bc == convert.fieldbc_from_jax(jsim.p_bc)
    assert tsim.grid == convert.grid_from_jax(jsim.grid)


def test_adapt_spec_is_the_jax_readers():
    tsim = _port(AMR)
    jsim = _quiet(J.build_simulation, J.parse_gfs(AMR))
    for f in ("cmax", "cfactor", "minlevel", "maxlevel", "istep",
              "maxcells"):
        assert getattr(tsim.adapt, f) == getattr(jsim.adapt, f), f


def test_lid_text_is_the_phase_config():
    """chip_smoke.gfs_lid_cfg, the configuration the card's gfs phase
    states for the lid's .gfs text, is the reader's at every level."""
    import chip_smoke
    for level in (4, 5):
        text = LID.replace("LEVEL", str(level)).replace("DTMAX", "0.02")
        assert _port(text).cfg == chip_smoke.gfs_lid_cfg(level)


# --- the runs, held to the pinned JAX runs --------------------------------

def _fields(sim, names):
    if hasattr(sim, "fine"):
        return {n: sim.fine(n) for n in names}
    return {n: sim.state[n] for n in names}


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-300))


def _check(ref, tsim, names, rtol=RTOL):
    got = _fields(tsim, names)
    for n in names:
        assert _rel(ref[n], got[n]) <= rtol, (n, _rel(ref[n], got[n]))
    assert tsim.time.i == int(ref["i"])
    assert abs(tsim.time.t - float(ref["t"])) <= 1e-12 * max(1.0, abs(
        float(ref["t"])))


def _jax_run(text, names, max_steps=None):
    tsim = _port(text)
    js = _jax(text, tsim)
    js.run(max_steps=max_steps) if max_steps else js.run()
    out = {n: np.asarray(js.fine(n) if hasattr(js, "fine")
                         else js.state[n]) for n in names}
    return {**out, "i": js.time.i, "t": js.time.t}


RUNS = {"lid": (LID5, ("U", "V", "P")),
        "vof": (VOF, ("U", "V", "P", "T")),
        "particulate": (PARTICULATE, ("U", "V", "P")),
        "amr": (AMR, ("U", "V", "P", "T"))}


def _pin_fn(name):
    text, names = RUNS[name]
    return lambda: _jax_run(text, names)


def _jax_particles():
    tsim = _port(PARTICULATE)
    js = _jax(PARTICULATE, tsim)
    js.run()
    st = js.particle_systems[0].state
    return {"U": js.state["U"], "V": js.state["V"], "P": js.state["P"],
            "pos": st["pos"], "vel": st["vel"], "i": js.time.i,
            "t": js.time.t}


def _jax_fft():
    """The FFT text's JAX build and two steps, with the white noise its
    GfsInitSpectra drew (jax.random.normal of split keys), which the port
    is given in place of torch's draws."""
    import jax
    seed = 3
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    noise = [np.asarray(jax.random.normal(k, (64, 64))) for k in keys]
    tsim = _port(FFT, cap=True)
    js = _jax(FFT, tsim)
    U0, V0 = np.asarray(js.state["U"]), np.asarray(js.state["V"])
    js.run(max_steps=2)
    return {"noise0": noise[0], "noise1": noise[1], "U0": U0, "V0": V0,
            "U": js.state["U"], "V": js.state["V"], "P": js.state["P"],
            "i": js.time.i, "t": js.time.t}


def _jax_poisson():
    text = POISSON.replace("LEVEL", "6")
    tsim = _port(text, cap=True)
    js = _jax(text, tsim)
    js.run()
    return {"P": js.state["P"]}


def _jax_advection():
    tsim = _port(ADVECTION)
    js = _quiet(J.build_simulation, J.parse_gfs(ADVECTION))
    js.run()
    return {"T": js.state["T"], "C": js.state["C"], "t": js.t,
            "i": js.i}


JAX_PINS = {"gfs_lid": _pin_fn("lid"), "gfs_vof": _pin_fn("vof"),
            "gfs_amr": _pin_fn("amr"), "gfs_particles": _jax_particles,
            "gfs_fft": _jax_fft, "gfs_poisson": _jax_poisson,
            "gfs_advection": _jax_advection}


@pytest.mark.parametrize("name", ["lid", "vof", "amr"])
def test_gfs_run_matches_the_pinned_jax_run(name):
    text, names = RUNS[name]
    ref = jax_pins.load(f"gfs_{name}")
    tsim = _port(text)
    tsim.run()
    _check(ref, tsim, names)


def test_particle_text_matches_the_pinned_jax_run():
    ref = jax_pins.load("gfs_particles")
    tsim = _port(PARTICULATE)
    tsim.run()
    _check(ref, tsim, ("U", "V", "P"))
    st = tsim.particle_systems[0].state
    for k in ("pos", "vel"):
        assert _rel(ref[k], st[k]) <= RTOL, k


def test_fft_text_matches_the_pinned_jax_run(monkeypatch):
    ref = jax_pins.load("gfs_fft")
    real = tfft.init_solenoidal
    noise = [torch.as_tensor(ref["noise0"]), torch.as_tensor(ref["noise1"])]
    monkeypatch.setattr(tfft, "init_solenoidal",
                        lambda grid, spec, **kw: real(grid, spec,
                                                      noise=noise))
    tsim = _port(FFT, cap=True)
    for n in ("U", "V"):
        assert _rel(ref[n + "0"], tsim.state[n]) <= 1e-12, n
    tsim.run(max_steps=2)
    _check(ref, tsim, ("U", "V", "P"))


def test_poisson_text_matches_the_pinned_jax_run():
    ref = jax_pins.load("gfs_poisson")
    tsim = _port(POISSON.replace("LEVEL", "6"), cap=True)
    tsim.run()
    assert _rel(ref["P"], tsim.state["P"]) <= RTOL


def test_advection_text_matches_the_pinned_jax_run():
    ref = jax_pins.load("gfs_advection")
    tsim = _port(ADVECTION)
    tsim.run()
    assert tsim.t == float(ref["t"]) and tsim.i == int(ref["i"])
    for n in ("T", "C"):
        assert _rel(ref[n], tsim.state[n]) <= RTOL, n


def test_poisson_converges_at_second_order():
    """test/poisson's sin(3 pi x) sin(3 pi y) through the .gfs text: the
    unbiased error norms fall by 4 +- 0.6 per level (levels 4-6)."""
    from gerris_tpu_torch.core.grid import center_coords
    from gerris_tpu_torch.ops.stencils import norms, unbiased_error
    errs = []
    for level in (4, 5, 6):
        s = _port(POISSON.replace("LEVEL", str(level)), cap=True).run()
        x, y = center_coords(s.grid, CPU, torch.float64)
        e = unbiased_error(s.state["P"] - torch.sin(3 * math.pi * x)
                           * torch.sin(3 * math.pi * y))
        errs.append(float(norms(e)["second"]))
    for a, b in zip(errs, errs[1:]):
        assert abs(a / b - 4.0) < 0.6, errs


def test_bc_expressions_see_the_time():
    """A time-dependent .gfs BC value sees t: the port's BCs call a value
    f(x, y, t), and the translated expression takes t as a keyword.  The
    JAX package calls the same closure with t in z's place (gerris_tpu
    core/bc.py:161-167 with gfs_config.py:344), so its BC is frozen at
    t = 0 in 2D."""
    text = LID5.replace("BcDirichlet U 1", "BcDirichlet U (t < 1. ? t : 1.)")
    tsim = _port(text)
    top = tsim.cfg.u_bcs[0].sides[1][1].value
    x = torch.linspace(-0.5, 0.5, 5, dtype=torch.float64)
    assert float(top(x, 0.5, 0.25)) == 0.25
    jsim = _quiet(J.build_simulation, J.parse_gfs(text))
    jtop = jsim.cfg.u_bcs[0].sides[1][1].value
    assert float(np.asarray(jtop(np.asarray([0.1]), 0.5, 0.25))) == 0.0


def test_a_tracer_source_is_a_source():
    """`Source C 1` gives tracer C the unit source (NSConfig.tracers'
    fourth slot); the JAX reader puts it in the diffusivity's slot
    (gfs_config.py:1715)."""
    text = LID5.replace("SourceViscosity 1e-3",
                        "SourceViscosity 1e-3\n  VariableTracer C\n"
                        "  Source C 1")
    tr = _port(text).cfg.tracers[0]
    assert tr[0] == "C" and tr[2] == 0.0 and tr[3](0.1, 0.2, 0.3) == 1.0
    jtr = _quiet(J.build_simulation, J.parse_gfs(text)).cfg.tracers[0]
    assert len(jtr) == 3 and float(jtr[2](0.1, 0.2, 0.3)) == 1.0


def test_unported_classes_raise_naming_their_slice():
    for cls in ("GfsRiver", "GfsOcean", "GfsSkewSymmetric",
                "GfsElectroHydro"):
        text = LID5.replace("GfsSimulation", cls)
        ps = G.parse_gfs(text)
        with pytest.raises(NotImplementedError, match="slice 8"):
            G.build_simulation(ps, device="cpu")


def test_particles_on_an_adaptive_mesh_raise():
    """The JAX reader builds the particle systems and drops them on its
    AMR branch (gfs_config.py:1988-2005), so the run goes on without its
    particles; the port's composite step has no particle phase and the
    reader refuses the text."""
    text = PARTICULATE.replace(
        "  SourceViscosity 1e-2",
        "  SourceViscosity 1e-2\n"
        "  AdaptVorticity { istep = 1 } { cmax = 0.1 maxlevel = 5 "
        "minlevel = 3 }")
    ps = G.parse_gfs(text)
    assert ps.particle_lists
    with pytest.raises(NotImplementedError, match="particle phase"):
        G.build_simulation(ps, device="cpu", dtype=torch.float64)
    ps = G.parse_gfs(PARTICULATE.replace("Refine 5", "Refine (x > 0 ? 5 : 4)"))
    with pytest.raises(NotImplementedError, match="particle phase"):
        G.build_simulation(ps, device="cpu", dtype=torch.float64)
