"""The composite NS step and its driver (gerris_tpu_torch/models/
amr_ns.py) on the CPU in float64.

Against the JAX package: tools/amr_reference.py's six short runs (the
oscillating droplet adapting at maxlevel 5 on the block engine with
composite_vof and block_advect, and pinned on the dense engine; the lid
cavity and a two-phase droplet adapting on the Hessian through the block
engine's unit and cell-dia solves; the capillary wave's graded static
mesh on a 1 x 3 box; a 3D lid cavity), the leaf counts after each
adaptation bit for bit and every field of every level to 1e-10 (of
max|field| times the projection's weight), pinned below as JAX_AMR; one
step of the oscillating droplet at maxlevel 4 on the block engine
(composite_vof, block_advect, adapting) against the JAX package run
live and eagerly (jax.disable_jit: the only JAX step of this file),
every field of every level to 1e-10 of its max; and config_from_jax's
AMR fields.  On the
port alone: the fully refined composite step against the uniform step
(< 2e-4, tests/test_amr_ns.py), the composite VOF advection's mass
across levels, the block engine never falling back (its warning an
error), the host reads per step, the default device, and the uniform
step bit for bit with and without the per-level grid argument of
density_fields, tension_sources and viscosity_field."""
import dataclasses
import math
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import amr_ns, ns  # noqa: E402
from gerris_tpu_torch.models.simulation import Simulation, Time  # noqa: E402
from gerris_tpu_torch.physics import vof  # noqa: E402
from gerris_tpu_torch.solvers import amr, poisson  # noqa: E402
from gerris_tpu_torch.solvers.composite import (CompositeGrid,  # noqa: E402
                                                grade_depth_map)
from gerris_tpu_torch.utils import convert  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import amr_reference as ref  # noqa: E402

# python3 tools/amr_reference.py (the JAX package on the CPU, float64):
# per case whether it ran on the block engine, the leaves after each
# adaptation (or the static mesh's), the last dt, and per field and
# level the two projections
JAX_AMR = {
    "osc_block": dict(
        blocks=True, leaves=[127, 127], dt=0.0022045855379188716,
        projections={
            "U": {
                3: [-0.007941074236053666,
                    0.013502163104142718],
                4: [0.06705596958073566,
                    -0.08272329413983412],
                5: [0.2635158081760623,
                    0.03373674037297206],
            },
            "V": {
                3: [0.03700775572658745,
                    0.029157761289405712],
                4: [-0.005989952118393526,
                    -0.003403346672288604],
                5: [0.2953361058391636,
                    0.44531151460158336],
            },
            "P": {
                3: [0.6673998769704077,
                    1.8245483928785076],
                4: [-2.5352884556553663,
                    7.252581770967068],
                5: [15.104472865158229,
                    35.36036451216981],
            },
            "Pmac": {
                3: [0.6685176149473833,
                    1.827275760376801],
                4: [-2.5286481990179057,
                    7.2618731767739275],
                5: [15.068362262314897,
                    35.41656014970153],
            },
            "Gx": {
                3: [1.1555114313669845,
                    -3.3221757736024893],
                4: [-14.268902154175398,
                    19.46874977761216],
                5: [-48.883215677110314,
                    -6.101216900817744],
            },
            "Gy": {
                3: [-8.831070999596614,
                    -5.998279392268156],
                4: [3.9726891332952325,
                    0.46803492693378057],
                5: [-61.936850536781044,
                    -93.3170279190071],
            },
            "T": {
                5: [1.440218381829469,
                    3.3855969999461912],
                4: [-0.2177340260506402,
                    0.6964499174299341],
                3: [0.06137226065380482,
                    0.16868882380696834],
            },
        }),
    "osc_dense": dict(
        blocks=False, leaves=[127, 127], dt=0.0022045855379188716,
        projections={
            "U": {
                3: [-0.007831129243798248,
                    0.013329362930752264],
                4: [0.06648614057185745,
                    -0.08394672540530963],
                5: [0.2647433940305046,
                    0.03373014132575418],
            },
            "V": {
                3: [0.036969840429521755,
                    0.02910109916011628],
                4: [-0.00698996078963789,
                    -0.0034210216341045343],
                5: [0.2940066843002526,
                    0.44614047946425284],
            },
            "P": {
                3: [0.667049137110948,
                    1.824904875494522],
                4: [-2.534983224979593,
                    7.254137415711],
                5: [15.10751305724232,
                    35.36325874382899],
            },
            "Pmac": {
                3: [0.6680151732596088,
                    1.82771051121761],
                4: [-2.5279605747221225,
                    7.26370936337935],
                5: [15.071580053628468,
                    35.419128950585026],
            },
            "Gx": {
                3: [1.6565715562816978,
                    -3.0201117184883874],
                4: [-15.71392535924863,
                    18.767614513935285],
                5: [-49.211882880887295,
                    -3.22758893504237],
            },
            "Gy": {
                3: [-8.104258637596047,
                    -6.519993887536338],
                4: [2.1677031065414725,
                    -0.3385456161030945],
                5: [-65.04406819764351,
                    -93.2506690504633],
            },
            "T": {
                5: [1.440218114380425,
                    3.385597005942086],
                4: [-0.2177340584306935,
                    0.6964498562489434],
                3: [0.061372260196566455,
                    0.1686888225501953],
            },
        }),
    "lid_block": dict(
        blocks=True, leaves=[112, 106], dt=0.030428167789610956,
        projections={
            "U": {
                3: [1.2572941512229967,
                    -0.3664907285710536],
                4: [-0.9482105488745272,
                    -0.7123788563731885],
                5: [-7.1958137400171935,
                    -1.0953521945134217],
            },
            "V": {
                3: [-0.07141112417365694,
                    0.6000943137681705],
                4: [0.8891452041780075,
                    0.46039566935771775],
                5: [1.815527847076797,
                    -3.02098363962121],
            },
            "P": {
                3: [0.8970321790185876,
                    -4.466212965523023],
                4: [-6.206380305080203,
                    -1.6393783658383003],
                5: [-9.364904460613833,
                    26.299436549298186],
            },
            "Pmac": {
                3: [0.09285756024645744,
                    -3.9543215882556133],
                4: [-4.461833500930027,
                    -2.0727122204608692],
                5: [-7.489832807398722,
                    25.197658977726],
            },
            "Gx": {
                3: [7.914605880224613,
                    -4.201933640681107],
                4: [-25.94949676454345,
                    -36.93186384488081],
                5: [-114.10195425813234,
                    -5.763036013745662],
            },
            "Gy": {
                3: [-2.6152091044234558,
                    -10.507398131025843],
                4: [2.3613097580705382,
                    -6.623547350336496],
                5: [-37.6400553884859,
                    51.20257275341804],
            },
        }),
    "drop_block": dict(
        blocks=True, leaves=[340, 448], dt=0.018926345144356958,
        projections={
            "U": {
                3: [0.936624531253937,
                    -0.42955982074554505],
                4: [0.21961157668003084,
                    -0.1684764774530496],
                5: [-4.177511590632356,
                    -2.1570462664825705],
            },
            "V": {
                3: [0.08461329540421275,
                    0.4109059179505965],
                4: [0.4048891921276825,
                    0.40581104340353],
                5: [1.3196988607935674,
                    -1.8440803036985365],
            },
            "P": {
                3: [-0.005642195565686736,
                    -0.7976450181922201],
                4: [-0.8787404813351349,
                    -0.7589490773995304],
                5: [-1.8190893493712312,
                    4.933729425224858],
            },
            "Pmac": {
                3: [-0.14442923586498785,
                    -0.5205862737565837],
                4: [-0.04016289997683653,
                    -0.6350745314992777],
                5: [-1.8386974113023058,
                    3.0942949692161346],
            },
            "Gx": {
                3: [2.2097889864929945,
                    -3.31146567057843],
                4: [-15.28044468611493,
                    -17.306440687734636],
                5: [-56.66924101350069,
                    12.105901312802793],
            },
            "Gy": {
                3: [-3.2770663977785066,
                    -7.117899683125533],
                4: [9.333947097912946,
                    -5.246316069214293],
                5: [-21.02018879224581,
                    28.826752204526045],
            },
            "T": {
                5: [-4.625869594803948,
                    7.648858490866676],
                4: [7.8027562527404815,
                    -0.19286551688857478],
                3: [-0.6584052783592581,
                    0.508105996417424],
            },
        }),
    "capwave": dict(
        blocks=False, leaves=[1344], dt=0.0031162355874104083,
        projections={
            "U": {
                3: [-0.015983977147276573,
                    0.003014553954333949],
                4: [-0.01342643356539918,
                    -0.05652092318568577],
                5: [0.0166004449519288,
                    -0.003968628181949478],
            },
            "V": {
                3: [-0.004379973242633537,
                    0.013243723825469591],
                4: [-0.007328122831299029,
                    -0.03904862473260234],
                5: [0.04281188404025061,
                    -0.028979824045651977],
            },
            "P": {
                3: [-0.18446368601862312,
                    -1.1569219616949555],
                4: [0.14343969178491323,
                    -0.7312440330629231],
                5: [1.090893013636144,
                    -0.9459584877632344],
            },
            "Pmac": {
                3: [-0.18302872365532097,
                    -1.1607574253115505],
                4: [0.1371940511886032,
                    -0.7302853361220887],
                5: [1.0843714218685925,
                    -0.9440519611383971],
            },
            "Gx": {
                3: [2.6523333651921464,
                    -0.5605631362805319],
                4: [2.0723981968543113,
                    9.17939483933947],
                5: [-2.4885043883717084,
                    0.37735691150124717],
            },
            "Gy": {
                3: [0.6816962691578564,
                    -2.1172680604323606],
                4: [1.1356506628333003,
                    6.31226294248923],
                5: [-7.133528799494799,
                    4.661248897763329],
            },
            "T": {
                5: [-29.14980640777845,
                    12.533151567554787],
                4: [3.175267639600124,
                    -25.98677120571838],
                3: [10.523706441683533,
                    -5.793961152742186],
            },
        }),
    "lid3d": dict(
        blocks=False, leaves=[120], dt=0.18505079825834544,
        projections={
            "U": {
                2: [-0.06211289737730347,
                    -0.1240829123929035],
                3: [0.9879387489245759,
                    -2.6706055225786036],
            },
            "V": {
                2: [0.07183905423307081,
                    -0.1834541433685887],
                3: [-0.649398374619079,
                    -0.5982457658114886],
            },
            "W": {
                2: [0.15864499985281982,
                    -0.05638290362234752],
                3: [-0.26277667304143537,
                    -0.18365080198565908],
            },
            "P": {
                2: [0.3832270849080785,
                    -0.11470363895026073],
                3: [0.41696426255214913,
                    1.2562870981825527],
            },
            "Pmac": {
                2: [-0.26332417973282424,
                    0.235102394322582],
                3: [0.5731627890320403,
                    0.8586420854306689],
            },
            "Gx": {
                2: [0.6608886728907705,
                    -0.8324268460342398],
                3: [-1.2605231752635868,
                    -0.4696606823692977],
            },
            "Gy": {
                2: [0.7220688527612193,
                    -0.4939074604363156],
                3: [-0.8098344312516585,
                    1.2673039415989185],
            },
            "Gz": {
                2: [0.14824119935946461,
                    -0.08879223020230852],
                3: [-1.2966064462910676,
                    0.4906197802023444],
            },
        }),
}


def _run(case, steps=None, level=5):
    cfg, kw, spec, dense = ref.build(case, "torch", level)
    sim = amr_ns.AMRSimulation(cfg, time=Time(end=10.0), device="cpu", **kw)
    if dense:
        sim._use_blocks, sim._brt, sim._btables = False, None, None
    sim.init(**ref.init_fields(cfg, spec, "torch"))
    with warnings.catch_warnings():
        # the block engine must not fall back on these routes
        warnings.simplefilter("error", RuntimeWarning)
        sim.run(max_steps=steps or ref.STEPS[case])
    return sim


@pytest.mark.parametrize("case", ref.CASES)
def test_amr_run_equals_the_reference(case):
    want = JAX_AMR[case]
    sim = _run(case)
    assert sim._use_blocks == want["blocks"]
    assert (sim.leaf_history or [sim.n_leaves()]) == want["leaves"]
    assert math.isclose(sim.dt, want["dt"], rel_tol=1e-10)
    assert set(sim.state) == set(want["projections"])
    for name, lv in want["projections"].items():
        assert set(sim.state[name]) == set(lv)
        for l, proj in lv.items():
            f = sim.state[name][l].numpy()
            for k, p in enumerate(proj):
                w = ref.weights(k, f.shape)
                bound = 1e-10 * np.abs(w).sum() * max(np.abs(f).max(), 1e-3)
                assert abs(float(np.sum(w * f)) - p) <= bound, (name, l, k)


LIVE_LEVEL, LIVE_STEPS = 4, 1


def test_amr_step_equals_the_live_reference():
    """The oscillating droplet (osc_block: the block engine, composite_vof,
    block_advect, adapting on interface_vorticity_criterion) at maxlevel
    LIVE_LEVEL through init, the initial projection and LIVE_STEPS steps,
    on the port and on the JAX package run eagerly here: the engine, the
    leaves after each adaptation and the dt equal, and every field of
    every level within 1e-10 of the JAX field's max."""
    info, want = ref.jax_run("osc_block", LIVE_STEPS, LIVE_LEVEL)
    sim = _run("osc_block", LIVE_STEPS, LIVE_LEVEL)
    assert sim._use_blocks and info["blocks"]
    assert sim.leaf_history == info["leaves"]
    assert math.isclose(sim.dt, info["dt"], rel_tol=1e-10)
    assert set(sim.state) == set(want)
    errs = {}
    for name, lv in want.items():
        assert set(sim.state[name]) == set(lv), name
        for l, a in lv.items():
            got = sim.state[name][l].numpy()
            assert got.shape == a.shape, (name, l)
            errs[name, l] = float(np.abs(got - a).max()) / max(
                float(np.abs(a).max()), 1e-300)
    assert max(errs.values()) <= 1e-10, errs


def _cavity(level):
    u_bc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                           top=bc.Dirichlet(1.0))
    v_bc = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    return ns.NSConfig(grid=Grid(level=level), u_bcs=(u_bc, v_bc), nu=1e-3)


def test_fully_refined_composite_matches_uniform():
    """Every leaf at lmax: the composite step is the uniform step up to
    the solves' tolerance (tests/test_amr_ns.py: < 2e-4 after 5 steps)."""
    cfg = _cavity(5)
    uni = Simulation(cfg, time=Time(end=1.0), device="cpu").init()
    uni.run(max_steps=5)
    mesh = CompositeGrid.build(Grid(level=4), {4: np.zeros((16, 16), bool),
                                               5: np.ones((32, 32), bool)})
    sim = amr_ns.AMRSimulation(cfg, mesh=mesh, time=Time(end=1.0),
                               device="cpu").init()
    sim.run(max_steps=5)
    for n in ("U", "V"):
        assert float((uni.state[n] - sim.fine(n)).abs().max()) < 2e-4


def test_composite_vof_conserves_mass_across_levels():
    """A droplet advected by a uniform flow out of a refined half into
    the coarse half (tests/test_amr_ns.py::
    test_amr_vof_flux_matching_across_levels): the leaves' volume to
    1e-10, the coarse centroid within half a coarse cell of the uniform
    run's."""
    lmin, lmax = 4, 6
    topo = amr.Topo(base=Grid(lmin), lmin=lmin, lmax=lmax)
    gf = topo.grid(lmax)
    x = torch.tensor(gf.centers[0])
    D = grade_depth_map(np.where(gf.centers[0] < 0.0, lmax,
                                 lmin).astype(np.int32))
    leaf = CompositeGrid.from_depth_map(topo.base, lmax, D,
                                        graded=True).leaf_arrays("cpu")
    cov = amr.covered_masks(leaf, topo)
    fbc = bc.default_scalar_bc(2)
    T = {lmax: vof.fraction_from_levelset(
        gf, lambda xx, yy: 0.12 - torch.sqrt((xx + 0.2) ** 2 + yy ** 2),
        device="cpu", dtype=torch.float64)}
    for l in range(lmax - 1, lmin - 1, -1):
        T[l] = poisson.restrict(T[l + 1])
    uf = {l: [torch.ones(topo.grid(l).face_shape(0), dtype=torch.float64),
              torch.zeros(topo.grid(l).face_shape(1), dtype=torch.float64)]
          for l in topo.levels}

    def mass(Td):
        return sum(float(torch.where(leaf[l], Td[l], 0.0).sum())
                   * topo.grid(l).cell_volume for l in topo.levels)

    m0 = mass(T)
    dt = 0.4 * gf.h
    Tu = T[lmax]
    for i in range(int(round(0.4 / dt))):
        T = amr_ns.amr_advect_vof(T, uf, topo, leaf, cov, fbc, dt,
                                  cstart=i % 2)
        Tu = vof.advect(Tu, uf[lmax], gf, fbc, dt, cstart=i % 2)
    assert abs(mass(T) - m0) / m0 < 1e-10
    Tc = Tu
    for _ in range(lmax - lmin):
        Tc = poisson.restrict(Tc)
    xc = torch.tensor(topo.grid(lmin).centers[0])
    w = torch.where(leaf[lmin], T[lmin], 0.0)
    cx, cxu = float((w * xc).sum() / w.sum()), float((Tc * xc).sum()
                                                      / Tc.sum())
    assert abs(cx - cxu) < 0.5 * topo.grid(lmin).h
    assert float(x.max()) > 0.0


def test_block_engine_fallback_warns(monkeypatch):
    """Tables that cannot be built warn (RuntimeWarning) and drop the run
    to the dense engine, as the reference does; the routes above run
    with that warning an error."""
    from gerris_tpu_torch.solvers import blockrt

    def broken(*a, **k):
        raise ValueError("no tables")
    monkeypatch.setattr(blockrt, "make_blockrt", broken)
    cfg, kw, _, _ = ref.build("lid_block", "torch")
    with pytest.warns(RuntimeWarning, match="blockrt disabled"):
        sim = amr_ns.AMRSimulation(cfg, device="cpu", **kw)
    assert not sim._use_blocks and sim._btables is None


def test_host_reads_per_adaptive_step():
    """An adapting step reads the host twice besides its solves' loop
    conditions: the criterion's costs (one transfer) and the CFL dt; the
    leaf count is the host depth map's."""
    sim = _run("osc_block", steps=1)
    before = sim.host_syncs
    sim.run(max_steps=2)
    # run() reads the dt once more on entry
    assert sim.host_syncs - before == 1 + 2 * 2
    assert sim.n_leaves() == sum(int(m.sum()) for m in sim.leaf.values())


def test_amr_simulation_runs_on_the_card_by_default():
    cfg, kw, _, _ = ref.build("capwave", "torch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            amr_ns.AMRSimulation(cfg, **kw)
    sim = amr_ns.AMRSimulation(cfg, device="cpu", **kw).init()
    assert sim.fine("U").device.type == "cpu"
    assert all(m.device.type == "cpu" for m in sim.leaf.values())
    cfg, kw, _, _ = ref.build("osc_block", "torch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            amr_ns.AMRSimulation(cfg, **kw)


def test_amr_simulation_refuses_what_the_step_lacks():
    cfg = _cavity(4)
    mesh = CompositeGrid.build(Grid(3), {3: np.zeros((8, 8), bool),
                                         4: np.ones((16, 16), bool)})
    for extra, match in ((dict(solid_phi=lambda x, y: x), "solids"),
                         (dict(body_force=(None, -1.0)), "body_force")):
        with pytest.raises(NotImplementedError, match=match):
            amr_ns.AMRSimulation(dataclasses.replace(cfg, **extra),
                                 mesh=mesh, device="cpu")


def test_config_from_jax_carries_the_amr_fields():
    jcfg = jns.NSConfig(
        grid=JGrid(level=4),
        u_bcs=(jbc.velocity_bc(0, 2), jbc.velocity_bc(1, 2)),
        vof_tracers=(("T", jbc.default_scalar_bc(2)),),
        block_advect=True, composite_vof=True)
    cfg = convert.config_from_jax(jcfg)
    assert cfg.block_advect and cfg.composite_vof
    plain = convert.config_from_jax(dataclasses.replace(
        jcfg, block_advect=False, composite_vof=False))
    assert not plain.block_advect and not plain.composite_vof
    state = convert.amr_state_from_numpy(
        {"U": {3: np.ones((8, 8)), 4: np.zeros((16, 16))}}, device="cpu",
        dtype=torch.float32)
    assert state["U"][3].dtype == torch.float32
    assert state["U"][4].shape == (16, 16)


def _mu(x, y, t=0.0, T1=None):
    return 1e-3 + 2e-3 * torch.clamp(T1, 0.0, 1.0) + 0.0 * x


def test_uniform_step_is_unchanged_by_the_grid_argument(monkeypatch):
    """density_fields, tension_sources and viscosity_field with grid=
    cfg.grid give the uniform step's outputs bit for bit, as without it
    (a two-phase step with tension and a variable viscosity)."""
    cfg = ns.NSConfig(
        grid=Grid(level=4), u_bcs=(bc.velocity_bc(0, 2),
                                   bc.velocity_bc(1, 2)),
        vof_tracers=(("T", bc.default_scalar_bc(2)),),
        tension=(("T", 0.5),), density=("T", 10.0, 1.0, 1),
        nu_var=_mu, nu_var_fields=(("T1", "T", 1),))
    g = cfg.grid
    x, y = (torch.tensor(c) for c in g.centers)
    st = {"U": 0.1 * torch.sin(3 * x) * torch.cos(2 * y),
          "V": 0.1 * torch.cos(x) * torch.sin(5 * y),
          "P": torch.zeros(g.shape, dtype=torch.float64),
          "T": torch.clamp((0.25 - torch.sqrt(x * x + y * y)) / g.h + 0.5,
                           0.0, 1.0)}
    st.update(Pmac=st["P"], Gx=st["P"], Gy=st["P"])
    plain = ns.ns_step(dict(st), 1e-3, 0.0, cfg)
    for name in ("density_fields", "tension_sources", "viscosity_field"):
        fn = getattr(ns, name)
        monkeypatch.setattr(ns, name, lambda *a, fn=fn, **k: fn(
            *a, **{**k, "grid": cfg.grid}))
    gridded = ns.ns_step(dict(st), 1e-3, 0.0, cfg)
    monkeypatch.undo()
    for k in plain:
        assert torch.equal(plain[k], gridded[k]), k
    # and per level: a level's grid, not cfg.grid, sets the cell size
    coarse = dataclasses.replace(g, level=3)
    Tc = poisson.restrict(st["T"])
    rho, alpha = ns.density_fields({"T": Tc}, cfg, grid=coarse)
    assert rho.shape == coarse.shape and alpha[0].shape == (9, 8)
    fs = ns.tension_sources({"T": Tc}, cfg, alpha=alpha, grid=coarse)
    assert fs[1].shape == (8, 9)
    mu = ns.viscosity_field({"T": Tc, "U": Tc}, cfg, grid=coarse)
    assert mu.shape == coarse.shape
