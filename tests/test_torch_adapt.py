"""Adaptation (gerris_tpu_torch/physics/adapt.py and the criteria and
depth maps of models/amr_ns.py) against the JAX package's on the CPU in
float64: the cost fields to 1e-12, and the host-side integer results
bit for bit (adapted meshes with and without hysteresis, depth maps from
costs with and without a leaf budget), the resampling, and
utils/convert's adapt_spec_from_jax."""
import dataclasses
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import amr_ns as jamr_ns  # noqa: E402
from gerris_tpu.physics import adapt as jadapt  # noqa: E402
from gerris_tpu.solvers.amr import Topo as JTopo  # noqa: E402

from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import amr_ns  # noqa: E402
from gerris_tpu_torch.physics import adapt  # noqa: E402
from gerris_tpu_torch.solvers.amr import Topo  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

LEVEL = 6


def bump(x, y, lib=np):
    return lib.exp(-((x - 0.1) ** 2 + (y - 0.1) ** 2) / (2 * 0.05 ** 2))


def _fields(seed=0):
    """Seeded velocities, a bump and a droplet fraction at level 6."""
    g = JGrid(LEVEL)
    x, y = (np.asarray(c) for c in g.centers)
    rng = np.random.default_rng(seed)
    u = np.sin(3 * x + rng.random()) * np.cos(2 * y) \
        + 0.01 * rng.standard_normal(g.shape)
    v = np.cos(2 * x) * np.sin(4 * y + rng.random())
    T = np.clip((0.2 - np.sqrt(x * x + y * y)) / g.h + 0.5, 0.0, 1.0)
    # a thin sheet for the thickness cost
    T = np.maximum(T, (np.abs(y - 0.3) < 1.2 * g.h).astype(float) * 0.7)
    return g, u, v, bump(x, y), T


def _walls(mod):
    return (mod.FieldBC.make(2, default=mod.Dirichlet(0.0),
                             top=mod.Dirichlet(1.0)),
            mod.FieldBC.uniform(mod.Dirichlet(0.0), 2))


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) \
        <= tol * max(1.0, float(np.abs(want).max()))


def test_costs_equal_the_reference():
    g, u, v, b, T = _fields()
    tg = Grid(LEVEL)
    walls, jwalls = _walls(bc), _walls(jbc)
    t = lambda a: torch.tensor(a)  # noqa: E731
    _close(adapt.gradient_cost(t(b), tg, bc.default_scalar_bc(2)),
           jadapt.gradient_cost(jnp.asarray(b), g, jbc.default_scalar_bc(2)))
    _close(adapt.vorticity_cost([t(u), t(v)], tg, list(walls)),
           jadapt.vorticity_cost([jnp.asarray(u), jnp.asarray(v)], g,
                                 list(jwalls)))
    _close(adapt.interface_cost(t(T)), jadapt.interface_cost(jnp.asarray(T)))
    for fbc, jfbc in ((walls[0], jwalls[0]),
                      (bc.FieldBC(((bc.Periodic(),) * 2,
                                   (bc.Neumann(),) * 2)),
                       jbc.FieldBC(((jbc.Periodic(),) * 2,
                                    (jbc.Neumann(),) * 2)))):
        _close(amr_ns.hessian_cost(t(u), tg, fbc, t=0.5),
               jamr_ns.hessian_cost(jnp.asarray(u), g, jfbc, t=0.5))
    _close(amr_ns.dilate(t(T), 3), jamr_ns.dilate(jnp.asarray(T), 3))


def _sims():
    """Stand-ins of an AMRSimulation with what the criteria read."""
    g, u, v, _, T = _fields(1)
    out = []
    for mod, G, Tp, arr in ((bc, Grid, Topo, torch.tensor),
                            (jbc, JGrid, JTopo, jnp.asarray)):
        walls = _walls(mod)
        cfg = types.SimpleNamespace(
            u_bcs=walls, vof_tracers=(("T", mod.default_scalar_bc(2)),))
        st = {"U": arr(u), "V": arr(v), "T": arr(T)}
        out.append(types.SimpleNamespace(
            topo=Tp(base=G(3), lmin=3, lmax=LEVEL), cfg=cfg,
            time=types.SimpleNamespace(t=0.25), fine=st.__getitem__))
    return out


@pytest.mark.parametrize("name", ["interface_vorticity_criterion",
                                  "streamline_curvature_cost",
                                  "thickness_cost"])
def test_criteria_equal_the_reference(name):
    sim, jsim = _sims()
    got, want = getattr(amr_ns, name)(sim), getattr(jamr_ns, name)(jsim)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        _close(a, b)
    assert float(got[0].abs().sum()) > 0


@pytest.mark.parametrize("maxcells", [None, 900])
def test_depth_maps_from_costs_equal_the_reference(maxcells):
    """The three cost channels with hysteresis from a previous map, and a
    leaf budget met by the threshold's bisection: equal bit for bit."""
    g, u, v, b, T = _fields(2)
    spec = amr_ns.AdaptSpec(criterion=None, cmax=0.02, minlevel=3,
                            maxlevel=LEVEL, maxcells=maxcells)
    jspec = jamr_ns.AdaptSpec(criterion=None, cmax=0.02, minlevel=3,
                              maxlevel=LEVEL, maxcells=maxcells)
    topo, jtopo = Topo(Grid(3), 3, LEVEL), JTopo(JGrid(3), 3, LEVEL)
    c0 = ((T > 1e-6) & (T < 1 - 1e-6)).astype(float)
    c1, c2 = np.abs(u), np.abs(b) * 10
    prev = None
    for k in range(2):
        D = amr_ns.depth_map_from_cost(c0 * k, c1, spec, topo, prev=prev,
                                       c2=c2)
        jD = jamr_ns.depth_map_from_cost(c0 * k, c1, jspec, jtopo, prev=prev,
                                         c2=c2)
        assert D.dtype == jD.dtype and np.array_equal(D, jD)
        prev = D
    n = amr_ns._leaf_count(D, spec)
    assert n == jamr_ns._leaf_count(jD, jspec)
    if maxcells is not None:
        assert n <= maxcells


def test_adapt_mesh_and_resample_equal_the_reference():
    """adapt_mesh from a gradient cost (fresh, and with hysteresis from a
    previous mesh) bit for bit; a field resampled onto the new mesh (a
    level the old one lacks prolonged) to 1e-12."""
    g, _, _, b, _ = _fields()
    cost = adapt.gradient_cost(torch.tensor(b), Grid(LEVEL),
                               bc.default_scalar_bc(2))
    jcost = jadapt.gradient_cost(jnp.asarray(b), g, jbc.default_scalar_bc(2))
    p = adapt.AdaptParams(cmax=0.01, minlevel=4, maxlevel=LEVEL)
    jp = jadapt.AdaptParams(cmax=0.01, minlevel=4, maxlevel=LEVEL)
    cg1 = adapt.adapt_mesh(cost, Grid(4), p)
    jcg1 = jadapt.adapt_mesh(jcost, JGrid(4), jp)
    assert cg1 == convert.composite_from_jax(jcg1)
    cg2 = adapt.adapt_mesh(cost * 0.5, Grid(4), p, previous=cg1)
    jcg2 = jadapt.adapt_mesh(jcost * 0.5, JGrid(4), jp, previous=jcg1)
    assert cg2 == convert.composite_from_jax(jcg2)
    assert cg2.n_leaves() >= adapt.adapt_mesh(cost * 0.5, Grid(4),
                                              p).n_leaves()
    # resample a field of levels 4-5 onto cg1 (levels 4-6)
    rng = np.random.default_rng(3)
    old = dataclasses.replace(cg1, lmax=5, _masks=cg1._masks[:2])
    jold = dataclasses.replace(jcg1, lmax=5, _masks=jcg1._masks[:2])
    u = {l: rng.standard_normal(Grid(l).shape) for l in (4, 5)}
    fbc, jfbc = bc.FieldBC.uniform(bc.Dirichlet(0.5), 2), \
        jbc.FieldBC.uniform(jbc.Dirichlet(0.5), 2)
    got = adapt.resample({l: torch.tensor(a) for l, a in u.items()}, old,
                         cg1, fbc)
    want = jadapt.resample({l: jnp.asarray(a) for l, a in u.items()}, jold,
                           jcg1, jfbc)
    assert set(got) == set(want) == {4, 5, 6}
    for l in want:
        _close(got[l], want[l])


def test_adapt_spec_from_jax():
    """The reference's named criteria map to the port's; a user callable
    raises NotImplementedError."""
    spec = jamr_ns.AdaptSpec(criterion=jamr_ns.interface_vorticity_criterion,
                             cmax=0.02, cfactor=3.0, minlevel=3, maxlevel=7,
                             istep=2, maxcells=5000)
    got = convert.adapt_spec_from_jax(spec)
    assert got == amr_ns.AdaptSpec(
        criterion=amr_ns.interface_vorticity_criterion, cmax=0.02,
        cfactor=3.0, minlevel=3, maxlevel=7, istep=2, maxcells=5000)
    with pytest.raises(NotImplementedError, match="criterion"):
        convert.adapt_spec_from_jax(dataclasses.replace(
            spec, criterion=lambda s: (None, None)))
    assert math.isfinite(got.cmax)
