"""The general metrics (gerris_tpu_torch/core/metric.py, the Grid helpers,
models/ns.py with ``metric``) against the JAX package on the CPU in
float64.

The factors of MetricStretch, MetricLonLat and MetricCubed and the maps
to 1e-14; the Poisson orders of tests/test_metric.py on the port.  The
step: the lid cavity of tests/test_metric.py under MetricStretch(1, 0.1)
(test/lake's factor) and MetricLonLat() at level 4, the initial
projection and one ns_step, against tools/metric_reference.py's run of
the JAX package (pinned below as JAX_METRIC_STEP), whose merged-cell
update is replaced there by the update of a cell that merges with none:
the reference's merges cells that no solid cuts under these metrics
(ROADMAP Queue 3, pinned by test_metric_merge_reference_fault), which
the C does not, nor the port.  No JAX step runs in this file."""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core import metric as jmetric  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.physics import solid as jsolid  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core import metric  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.physics import solid  # noqa: E402
from gerris_tpu_torch.solvers.poisson import MultilevelParams  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import metric_reference  # noqa: E402

CPU = torch.device("cpu")
RTOL = 1e-10

METRICS = [
    ("stretch", jmetric.MetricStretch(1.0, 0.1)),
    ("stretch2", jmetric.MetricStretch(0.3, 2.0)),
    ("lonlat", jmetric.MetricLonLat()),
    ("lonlat_band", jmetric.MetricLonLat(math.pi / 2.0)),
    ("cubed", jmetric.MetricCubed()),
]

# tools/metric_reference.py at level 4 (python3 tools/metric_reference.py;
# the JAX package on the CPU in float64, its merged-cell update replaced
# by the update of a cell that merges with none): per metric, after the
# initial projection and after one ns_step, each field's projections on
# NPROJ fixed fields of normal deviates
JAX_METRIC_STEP = {
    "stretch": {
        "init": {
            "U": [0.6196728596988452, -0.28637996274604494],
            "V": [0.012104407950658598, 0.030855093894533767],
            "Gx": [-103.61445399896074, -73.85622180090988],
            "Gy": [9.684072148168227, 39.67913775833272],
            "P": [17.926654335270484, -12.594556686525497],
            "Pmac": [0.0, 0.0],
        },
        "step": {
            "U": [0.5688964046257302, -0.7024057580751678],
            "V": [-0.015660880676825924, 0.01399470547846563],
            "Gx": [-21.783181669624234, -60.37467170088632],
            "Gy": [-0.4784769600266756, 0.2879340671016705],
            "P": [-6.306269540532774, -8.016499802842043],
            "Pmac": [2.948232336848113, -1.8196394707285388],
        },
    },
    "lonlat": {
        "init": {
            "U": [0.03479179975133512, -0.0881717545358684],
            "V": [-0.6424511293526401, 0.258958648168696],
            "Gx": [-56.82396920315989, -89.712878457724],
            "Gy": [62.04851513243213, 21.43085341639975],
            "P": [-2.771468498169112, -14.608168644686767],
            "Pmac": [0.0, 0.0],
        },
        "step": {
            "U": [0.05913305018675752, -0.030792744006095933],
            "V": [-0.6703152475532619, 0.23468897939598987],
            "Gx": [-7.466206756185057, -5.685672723946517],
            "Gy": [2.7443338790439324, 0.7395413015332662],
            "P": [0.7777443523242142, -0.31272192572405644],
            "Pmac": [1.243629400474533, -1.0896093938429965],
        },
    },
}


@pytest.mark.parametrize("grid_kw", [dict(level=4), dict(level=3, dim=3),
                                     dict(level=3, extents=(1, 3),
                                          origin=(-0.5, 0.0))])
def test_grid_helpers_match_jax(grid_kw):
    """length, cell_volume, coarser, finer and face_centers as the JAX
    package's Grid gives them."""
    jg, tg = JGrid(**grid_kw), Grid(**grid_kw)
    for ax in range(tg.dim):
        assert tg.length(ax) == jg.length(ax)
        got = tg.face_centers(ax, CPU)
        for a, b in zip(jg.face_centers(ax), got):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert tg.cell_volume == jg.cell_volume
    assert tg.coarser() == Grid(**{**grid_kw, "level": tg.level - 1})
    assert tg.finer().level == jg.finer().level == tg.level + 1
    assert tg.face_centers(0, CPU, torch.float32)[0].dtype == torch.float32


@pytest.mark.parametrize("name,jm", METRICS, ids=[m[0] for m in METRICS])
def test_metric_weights_match_jax(name, jm):
    """Each metric's cell and face factors within 1e-14 of the JAX
    package's at level 5, carried over by convert.metric_from_jax."""
    jg, tg = JGrid(5), Grid(5)
    tm = convert.metric_from_jax(jm)
    cm, (fx, fy) = jm.weights(jg)
    tcm, (tfx, tfy) = tm.weights(tg, CPU)
    for a, b in ((cm, tcm), (fx, tfx), (fy, tfy)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert np.max(np.abs(a - b.numpy())) <= 1e-14 * np.max(np.abs(a))
    assert tm.weights(tg, CPU, torch.float32)[0].dtype == torch.float32


def test_maps_match_jax():
    """MapTransform and MapProjection (Mercator and plate carree) against
    the JAX package's, and their round trips."""
    jt, tt = jmetric.MapTransform(0.3, -0.2, 30.0), \
        metric.MapTransform(0.3, -0.2, 30.0)
    x, y = np.array([0.1, -0.4, 0.25]), np.array([0.3, 0.0, -0.45])
    for f in ("forward", "inverse"):
        a = getattr(jt, f)(x, y)
        b = getattr(tt, f)(torch.from_numpy(x), torch.from_numpy(y))
        assert all(np.allclose(p, q.numpy(), rtol=0, atol=1e-15)
                   for p, q in zip(a, b))
    lon = np.array([-30.0, 0.0, 45.0])
    lat = np.array([-60.0, 10.0, 70.0])
    for kind in ("mercator", "lonlat"):
        jp = jmetric.MapProjection(kind, L=2.0, lon0=10.0)
        tp = convert.metric_from_jax(jp)
        assert tp == metric.MapProjection(kind, 2.0, 10.0)
        a, b = jp.forward(jnp.asarray(lon), jnp.asarray(lat)), \
            tp.forward(lon, lat)
        assert all(np.allclose(np.asarray(p), q.numpy(), rtol=1e-14,
                               atol=1e-14) for p, q in zip(a, b))
        lon2, lat2 = tp.inverse(*b)
        assert np.max(np.abs(lon2.numpy() - lon)) < 1e-10
        assert np.max(np.abs(lat2.numpy() - lat)) < 1e-10


def test_stretch_and_lonlat_poisson_orders():
    """tests/test_metric.py's Poisson gates on the port (the card runs them
    too, chip_smoke.metric_gate): the stretched box's order in (1.8,
    2.2), the latitude band's above 1.6 with its error below 5e-4."""
    es, el = chip_smoke.stretch_poisson(CPU), chip_smoke.lonlat_poisson(CPU)
    assert chip_smoke.STRETCH_ORDER[0] < math.log2(es[0] / es[1]) < \
        chip_smoke.STRETCH_ORDER[1]
    assert math.log2(el[0] / el[1]) > chip_smoke.LONLAT_ORDER_MIN
    assert el[-1] < chip_smoke.LONLAT_ERR_MAX


def test_cubed_panel_area():
    """tests/test_metric.py::test_cubed_panel_area on the port: the panel
    covers a sixth of the sphere, its factors symmetric."""
    g = Grid(level=6)
    cm, _ = metric.MetricCubed().weights(g, CPU)
    area = float(cm.sum()) * g.h * g.h
    assert abs(area - 4 * math.pi / 6) / (4 * math.pi / 6) < 1e-3
    assert float((cm - cm.flip(0)).abs().max()) < 1e-12
    assert float((cm - cm.flip(1)).abs().max()) < 1e-12


def _cavity(level, **kw):
    u_bc = bc.FieldBC.make(2, default=bc.Dirichlet(0.0),
                           top=bc.Dirichlet(1.0))
    return tns.NSConfig(grid=Grid(level), nu=1e-3,
                        u_bcs=(u_bc, bc.FieldBC.uniform(bc.Dirichlet(0.0),
                                                        2)), **kw)


def _state(grid):
    x, y = tns.cell_centers(grid, CPU, torch.float64)
    u, v = metric_reference.initial_state(x, y)
    z = torch.zeros(grid.shape, dtype=torch.float64)
    return {"U": u, "V": v, "P": z, "Pmac": z, "Gx": z, "Gy": z}


def test_identity_metric_step_equals_the_plain_step():
    """tests/test_metric.py::test_identity_metric_ns_equality on the port:
    under MetricStretch(1, 1) the weighted step (the generic advection,
    face-coefficient solves, K15's plain version) gives the plain step's
    velocities at convergence, and its mean-free pressure."""
    # the plain step's coarsest dense solve at 16^2 (256 unknowns): the
    # default's 32^2 eigendecomposition costs seconds on a loaded host
    tight = MultilevelParams(tolerance=1e-10, nitermax=60,
                             dense_coarse_max=256)
    kw = dict(projection=tight, approx_projection=tight,
              diffusion_params=tight)
    cfg0 = _cavity(5, **kw)
    cfg1 = _cavity(5, metric=metric.MetricStretch(1.0, 1.0), **kw)
    s = _state(cfg0.grid)
    dt = 0.2 * cfg0.grid.h
    a = tns.ns_step(dict(s), dt, 0.0, cfg0)
    b = tns.ns_step(dict(s), dt, 0.0, cfg1)
    for k in ("U", "V"):
        assert float((a[k] - b[k]).abs().max()) < 1e-8, k
    dp = (a["P"] - a["P"].mean()) - (b["P"] - b["P"].mean())
    assert float(dp.abs().max()) < 1e-6


@pytest.mark.parametrize("name", ["stretch", "lonlat"])
def test_metric_step_matches_jax(name):
    """The cavity under ``name``'s metric at level 4: the initial
    projection and one ns_step, each field's projections within 1e-10 of
    their scale (the sum of the absolute products) of the pinned JAX
    values (JAX_METRIC_STEP); no merge group, no Dirichlet surface."""
    m = dict(stretch=metric.MetricStretch(1.0, 0.1),
             lonlat=metric.MetricLonLat())[name]
    cfg = _cavity(metric_reference.LEVEL, metric=m)
    grid = cfg.grid
    s0 = _state(grid)
    dt = 0.2 * grid.h
    w = tns._weights(cfg, s0["U"])
    assert w.groups is None and w.ds is None
    t0 = tns.initial_projection(s0, dt, 0.0, cfg)
    t1 = tns.ns_step(t0, dt, 0.0, cfg, first_step=True)
    for phase, st in (("init", t0), ("step", t1)):
        assert not metric_reference.mismatches(
            st, JAX_METRIC_STEP[name][phase], grid.shape, RTOL), phase


@pytest.mark.parametrize("m", [jmetric.MetricStretch(1.0, 0.1),
                               jmetric.MetricLonLat(),
                               jmetric.MetricCubed()],
                         ids=["stretch", "lonlat", "cubed"])
def test_metric_merge_reference_fault(m):
    """A reference fault (gerris_tpu/models/ns.py:396-410,
    physics/solid.py:331-341): with a metric and no solid the JAX step
    still runs its merged-cell update on the metric's factors, whose a / s
    test calls a cell small wherever cm / fm < 1/2 (every cell above 45
    degrees of latitude, every cell of MetricStretch(1, 0.1)), so given a
    zero increment it changes cells; the C merges cut cells only.  The
    port's weights under a metric hold no merge groups, and its update
    leaves every cell as it was.  MetricCubed's factors call no cell
    small: there both leave them."""
    tg = Grid(4)
    cfg = tns.NSConfig(grid=tg, u_bcs=chip_smoke.walls(),
                       metric=convert.metric_from_jax(m))
    v = np.random.default_rng(0).standard_normal(tg.shape)
    tv = torch.from_numpy(v)
    w = tns._weights(cfg, tv)
    # the JAX update on the metric's factors (the port's, which are the
    # JAX package's to 1e-14: test_metric_weights_match_jax)
    ref = np.asarray(jsolid.merged_cell_update(
        jnp.asarray(v), jnp.zeros(tg.shape), jnp.asarray(w.a.numpy()),
        tuple(jnp.asarray(f.numpy()) for f in w.s)))
    changed = int((np.abs(ref - v) > 1e-12).sum())
    assert w.groups is None
    got = tns.solid_mod.cell_update(tv, torch.zeros_like(tv), w.a)
    assert float((got - tv).abs().max()) <= 1e-15
    if isinstance(m, jmetric.MetricCubed):
        assert changed == 0
    else:
        assert changed > 50


def test_solid_with_metric_merges_cut_cells_only():
    """A solid under a metric: the weights are the products of the
    fractions and the factors (the JAX package's _weights, to 1e-15), and
    only the cells the solid cuts can be small: the merge groups are those
    cells and their targets, and given a zero increment the port's update
    leaves every other cell as it was, where the JAX package's, calling
    whole cells small, changes many more."""
    def jphi(x, y):
        return jnp.sqrt(x * x + y * y) - 0.2

    def tphi(x, y):
        return torch.sqrt(x * x + y * y) - 0.2

    jm = jmetric.MetricStretch(1.0, 0.1)
    # the JAX package's _weights (ns.py:622-639): the fractions times the
    # metric's factors
    fa, fs = jsolid.solid_fractions(JGrid(5), jphi)
    cm, fm = jm.weights(JGrid(5))
    ja, js = fa * cm, tuple(f * m for f, m in zip(fs, fm))
    cfg = tns.NSConfig(grid=Grid(5), u_bcs=chip_smoke.walls(),
                       solid_phi=tphi, metric=convert.metric_from_jax(jm))
    z = torch.zeros(cfg.grid.shape, dtype=torch.float64)
    w = tns._weights(cfg, z)
    assert np.max(np.abs(np.asarray(ja) - w.a.numpy())) <= 1e-15
    for a, b in zip(js, w.s):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) <= 1e-15 * \
            np.max(np.abs(np.asarray(a)))
    frac = solid.solid_fractions(cfg.grid, tphi, CPU)[0]
    cut = (frac > 0.0) & (frac < 1.0)
    small, _ = solid._merge_targets(w.a, w.s, cut)
    assert int(small.sum()) > 0 and not bool((small & ~cut).any())
    member = torch.zeros(z.numel(), dtype=torch.bool)
    member[w.groups.members] = True
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(z.shape))
    got = solid.merged_cell_update(v, z, w.a, w.s, w.groups)
    assert float((got - v).reshape(-1)[~member].abs().max()) <= 1e-15
    ref = np.asarray(jsolid.merged_cell_update(
        jnp.asarray(v.numpy()), jnp.zeros(z.shape), ja, js))
    assert int((np.abs(ref - v.numpy()) > 1e-12).sum()) > \
        2 * int(member.sum())
