"""The JAX -> port carry-over: schedule floors, BCs, config fields outside
the slice, and state (dict or .npz)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core import metric as jmetric  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.core import grid as tgrid  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

from test_bench_schedule import cavity_cfg  # noqa: E402


@pytest.mark.parametrize("jp,want", [
    # the bench projections: nrelax 4 -> tpu_nrelax 5, coarsest -> 40
    (jpoisson.MultilevelParams(ncycles=1, omega=1.5, tpu_nrelax=5),
     tpoisson.MultilevelParams(nrelax=5, omega=1.5, coarsest_relax=40,
                               ncycles=1)),
    # the bench diffusion: 1 sweep stays 1
    (jpoisson.MultilevelParams(ncycles=1, nrelax=1, tpu_nrelax=1),
     tpoisson.MultilevelParams(nrelax=1, coarsest_relax=40, ncycles=1)),
    # the reference default, the adaptive loop: tpu_nrelax 8 raises nrelax
    # and the coarsest sweeps to 2 * 8 (poisson.py:1139-1143); the fused
    # cycle's 40 is not the adaptive relax-coarsest branch's
    (jpoisson.MultilevelParams(),
     tpoisson.MultilevelParams(nrelax=8, coarsest_relax=16, ncycles=0)),
    # floors never lower an explicit schedule
    (jpoisson.MultilevelParams(ncycles=2, nrelax=12, coarsest_relax=50,
                               tpu_nrelax=3),
     tpoisson.MultilevelParams(nrelax=12, coarsest_relax=50, ncycles=2)),
    (jpoisson.MultilevelParams(ncycles=1, tpu_nrelax=30),
     tpoisson.MultilevelParams(nrelax=30, coarsest_relax=60, ncycles=1)),
    # the bench's cfg_ada (bench.py:174-179): adaptive, tpu_nrelax 5
    (jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100, tpu_nrelax=5),
     tpoisson.MultilevelParams(nrelax=5, coarsest_relax=10)),
    # every field carries over
    (jpoisson.MultilevelParams(tolerance=1e-6, erelax=2, minlevel=3,
                               nitermax=7, nitermin=2, coarse_top=256,
                               dense_coarse_max=1024, tpu_nrelax=1),
     tpoisson.MultilevelParams(tolerance=1e-6, erelax=2, minlevel=3,
                               nitermax=7, nitermin=2, coarse_top=256,
                               dense_coarse_max=1024)),
    # a registry solver runs unfloored (poisson.py:1130-1132)
    (jpoisson.MultilevelParams(nrelax=2, solver="relax", ncycles=1),
     tpoisson.MultilevelParams(nrelax=2, solver="relax", ncycles=1)),
    (jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100, solver="relax"),
     tpoisson.MultilevelParams(solver="relax")),
])
def test_params_from_jax_floors(jp, want):
    assert convert.params_from_jax(jp) == want


def test_params_from_jax_refuses_folds_and_maps_none():
    """None maps to diffuse's default as the TPU runs it: in 2D the
    reference's solve raises it to tpu_nrelax 8 and 16 coarsest sweeps
    (poisson.py:1139-1143, reached from diffusion.py:40-46).  The fold
    knobs, which the port refused before K16/K17, now carry over as the
    bench sets them (bench.py:142-150: GERRIS_FOLD_CORRECT sets both)."""
    assert convert.params_from_jax(None).ncycles == 0
    # diffuse's default (gerris_tpu/solvers/diffusion.py:40-44), floored
    assert convert.params_from_jax(None) == tpoisson.MultilevelParams(
        tolerance=1e-3, nitermax=10, nrelax=8, coarsest_relax=16)
    for fold_div, fold_correct in ((True, False), (True, True)):
        jp = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100,
                                       ncycles=1, omega=1.5, tpu_nrelax=5,
                                       fold_div=fold_div,
                                       fold_correct=fold_correct)
        assert convert.params_from_jax(jp) == tpoisson.MultilevelParams(
            nrelax=5, omega=1.5, coarsest_relax=40, ncycles=1,
            fold_div=fold_div, fold_correct=fold_correct)
    assert not convert.params_from_jax(jpoisson.MultilevelParams()).fold_div


@pytest.mark.parametrize("dim,want", [
    # the TPU's floors in 2D (poisson.py:1139-1143)
    (2, dict(nrelax=8, coarsest_relax=16)),
    # none in 3D (poisson.py:191): diffuse's default as it is
    (3, dict(nrelax=4, coarsest_relax=8)),
])
def test_params_from_jax_none_by_dim(dim, want):
    got = convert.params_from_jax(None, dim)
    assert got == tpoisson.MultilevelParams(tolerance=1e-3, nitermax=10,
                                            **want)


@pytest.mark.parametrize("dim,want", [(2, (8, 16)), (3, (4, 8))])
def test_config_from_jax_default_diffusion_schedule(dim, want):
    """A JAX config that leaves diffusion_params at None (the two-phase
    configuration, __graft_entry__._dryrun_twophase) converts to the
    schedule the TPU runs: nrelax 8 and 16 coarsest sweeps in 2D, 4 and
    8 in 3D.  A port-native NSConfig keeps None (diffuse's default)."""
    if dim == 2:
        jcfg = dataclasses.replace(cavity_cfg(5), diffusion_params=None)
    else:
        jcfg = dataclasses.replace(bench_3d_cfg(level=4),
                                   diffusion_params=None)
    d = convert.config_from_jax(jcfg).diffusion_params
    assert (d.nrelax, d.coarsest_relax, d.tolerance, d.nitermax) == \
        want + (1e-3, 10)
    port = dataclasses.replace(convert.config_from_jax(jcfg),
                               diffusion_params=None)
    assert port.diffusion_params is None


def test_config_from_jax_bench():
    cfg = convert.config_from_jax(cavity_cfg(6))
    assert cfg.grid.shape == (64, 64) and cfg.grid.h == 1.0 / 64
    assert cfg.nu == 1e-3 and cfg.beta == 1.0
    u_bc, v_bc = cfg.u_bcs
    assert u_bc.sides[1][1] == tbc.Dirichlet(1.0)
    assert u_bc.sides[0] == (tbc.Dirichlet(0.0), tbc.Dirichlet(0.0))
    assert v_bc == tbc.FieldBC.uniform(tbc.Dirichlet(0.0), 2)
    assert cfg.p_bc == tbc.default_scalar_bc(2)
    assert cfg.advection.cfl == 0.8
    assert not cfg.div_in_src
    folded = convert.config_from_jax(
        dataclasses.replace(cavity_cfg(6), div_in_src=True))
    assert folded.div_in_src


@pytest.mark.parametrize("field,value", [
    ("solid_phi", lambda x, y: x),
    ("pack_faces", True),
    ("particle_coupling", True),
])
def test_config_from_jax_refuses_fields_outside_slice(field, value):
    cfg = dataclasses.replace(cavity_cfg(6), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        convert.config_from_jax(cfg)


def _age(x, y, t):
    return 1.0 + 0.0 * x


def test_config_from_jax_carries_tracers():
    """Tracers carry over (refused before slice 3c): the BCs, D, a
    constant source as it is, and a JAX callable source only through
    its torch counterpart (``tracer_sources``); without one it raises,
    naming the tracer."""
    fbc = jbc.FieldBC.make(2, left=jbc.Dirichlet(1.0))
    cfg = dataclasses.replace(cavity_cfg(6), tracers=(
        ("T", fbc, 0.0), ("S", jbc.default_scalar_bc(2), 1e-3, 2.0)))
    got = convert.config_from_jax(cfg).tracers
    assert got == (("T", tbc.FieldBC.make(2, left=tbc.Dirichlet(1.0)), 0.0),
                   ("S", tbc.default_scalar_bc(2), 1e-3, 2.0))
    cfg = dataclasses.replace(cfg, tracers=(
        ("A", jbc.default_scalar_bc(2), 0.0, lambda x, y, t: 1.0 + 0 * x),))
    with pytest.raises(NotImplementedError, match="'A'"):
        convert.config_from_jax(cfg)
    got = convert.config_from_jax(cfg, tracer_sources={"A": _age})
    assert got.tracers[0][3] is _age


def test_fieldbc_from_jax_refuses_callables_and_navier():
    """A JAX callable value without its torch counterpart is refused.
    Since slice 3c a Navier side is not: it carries over as it is
    (``test_fieldbc_from_jax_carries_navier`` holds its padding)."""
    fbc = jbc.FieldBC.make(2, top=jbc.Dirichlet(lambda x, y: x))
    with pytest.raises(NotImplementedError):
        convert.fieldbc_from_jax(fbc)
    got = convert.fieldbc_from_jax(fbc, {(1, 1): _age})
    assert got.sides[1][1].value is _age
    got = convert.fieldbc_from_jax(jbc.FieldBC.uniform(jbc.Navier(0.1), 2))
    assert got == tbc.FieldBC.uniform(tbc.Navier(0.1), 2)
    per = jbc.FieldBC(((jbc.Neumann(0.5), jbc.Dirichlet(2.0)),
                       (jbc.Periodic(), jbc.Periodic())))
    got = convert.fieldbc_from_jax(per)
    assert got.is_periodic(1) and not got.is_periodic(0)
    assert got.sides[0] == (tbc.Neumann(0.5), tbc.Dirichlet(2.0))


def test_fieldbc_from_jax_carries_navier():
    """A Navier side carries over (refused before slice 3c) and pads as
    gerris_tpu pads it, (2 lambda - h) / (2 lambda + h) * interior."""
    fbc = jbc.FieldBC.make(2, bottom=jbc.Navier(0.1), top=jbc.Navier(0.0))
    got = convert.fieldbc_from_jax(fbc)
    assert got.sides[1] == (tbc.Navier(0.1), tbc.Navier(0.0))
    grid = JGrid(level=4)
    v = np.random.default_rng(0).standard_normal(grid.shape)
    ref = jbc.apply_bc(jnp.asarray(v), grid, fbc, 2)
    out = tbc.apply_bc(torch.from_numpy(v), convert.grid_from_jax(grid),
                       got, 2)
    assert np.array_equal(np.asarray(ref), out.numpy())


def test_state_from_numpy_dict_and_npz(tmp_path):
    rng = np.random.default_rng(3)
    names = list(jns.velocity_names(2)) + ["P", "Pmac"] + \
        list(jns.gradient_names(2))
    st = {n: rng.standard_normal((16, 16)) for n in names}
    got = convert.state_from_numpy(st, "cpu", torch.float32)
    assert set(got) == set(names)
    for n in names:
        assert got[n].dtype == torch.float32 and got[n].is_contiguous()
        assert np.array_equal(got[n].numpy(), st[n].astype(np.float32))
    path = tmp_path / "state.npz"
    np.savez(path, **st)
    with np.load(path) as z:
        got = convert.state_from_numpy(z, device="cpu")
    for n in names:
        assert got[n].dtype == torch.float64
        assert np.array_equal(got[n].numpy(), st[n])


def bench_3d_cfg(level=7, dense_coarse_max=4096):
    """The bench's 3D figure (bench.py:279-294): the lid cavity in 3D
    under the fixed schedule, projections 1 cycle at omega 1.5 and
    tpu_nrelax 5, diffusion 1 sweep."""
    grid = JGrid(level=level, dim=3)
    ub = jbc.FieldBC.make(3, default=jbc.Dirichlet(0.0),
                          top=jbc.Dirichlet(1.0))
    vb = jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 3)
    mp1 = jpoisson.MultilevelParams(tolerance=1e-3, nitermax=100, ncycles=1,
                                    omega=1.5, tpu_nrelax=5,
                                    dense_coarse_max=dense_coarse_max)
    mpd = dataclasses.replace(mp1, nrelax=1, omega=1.0, tpu_nrelax=1)
    return jns.NSConfig(grid=grid, u_bcs=(ub, vb, vb), nu=1e-3, beta=1.0,
                        projection=mp1, approx_projection=mp1,
                        diffusion_params=mpd)


def test_config_from_jax_3d_bench_keeps_schedule():
    """In 3D the TPU applies no floor (poisson.py:191): the bench's
    projections keep nrelax 4 and 8 coarsest sweeps, the diffusion 1."""
    cfg = convert.config_from_jax(bench_3d_cfg())
    assert cfg.grid.shape == (128, 128, 128)
    for p in (cfg.projection, cfg.approx_projection):
        assert (p.nrelax, p.coarsest_relax, p.omega, p.ncycles) == \
            (4, 8, 1.5, 1)
    d = cfg.diffusion_params
    assert (d.nrelax, d.coarsest_relax, d.omega) == (1, 8, 1.0)
    assert cfg.u_bcs[0].sides[1][1] == tbc.Dirichlet(1.0)
    assert cfg.p_bc == tbc.default_scalar_bc(3)
    jp = jpoisson.MultilevelParams(tpu_nrelax=8)
    assert convert.params_from_jax(jp, dim=3) == tpoisson.MultilevelParams()
    assert convert.params_from_jax(jp).nrelax == 8


def _mu3(x, y, z, t=0.0, T1=None):
    return 10.0 * T1 + (1.0 - T1)


def _gz(x, y, z, t=0.0):
    return -0.5 + 0.0 * z


def _twophase_3d():
    """A 3D two-phase JAX NSConfig: VOF, tension, density, a body force
    with a constant and a callable component, a variable viscosity."""
    return jns.NSConfig(
        grid=JGrid(level=3, dim=3, origin=(0.0, 0.0, 0.0),
                   extents=(1, 2, 1)),
        u_bcs=tuple(jbc.velocity_bc(c, 3) for c in range(3)), nu=0.0,
        vof_tracers=(("T", jbc.default_scalar_bc(3)),),
        tension=(("T", 24.5),), density=("T", 1000.0, 100.0, 1),
        body_force=(None, -0.98, lambda x, y, z, t=0.0: -0.5 + 0.0 * z),
        nu_var=lambda x, y, z, t=0.0, T1=None: 10.0 * T1 + (1.0 - T1),
        nu_var_fields=(("T1", "T", 1),))


def test_config_from_jax_3d_two_phase():
    """A 3D two-phase NSConfig carries over (refused in 3D before slice
    3d): the grid and its box, the VOF tracer, tension, density, the
    constant force component as it is and the callable ones and nu_var
    through their torch counterparts, and the schedules as given (no TPU
    floors in 3D)."""
    jcfg = _twophase_3d()
    with pytest.raises(NotImplementedError, match="nu_var"):
        convert.config_from_jax(jcfg, body_force=(None, None, _gz))
    got = convert.config_from_jax(jcfg, nu_var=_mu3,
                                  body_force=(None, None, _gz))
    assert got.dim == 3 and got.grid.shape == (8, 16, 8)
    assert got.vof_tracers == (("T", tbc.default_scalar_bc(3)),)
    assert got.tension == (("T", 24.5),)
    assert got.density == ("T", 1000.0, 100.0, 1)
    assert got.body_force == (None, -0.98, _gz) and got.nu_var is _mu3
    assert got.u_bcs == tuple(tbc.velocity_bc(c, 3) for c in range(3))
    assert got.projection == convert.params_from_jax(jcfg.projection, 3)
    assert got.projection.nrelax == jcfg.projection.nrelax


@pytest.mark.parametrize("what", ["tension_css", "contact"])
def test_config_from_jax_3d_refuses_css_and_contact(what):
    """CSS tension and contact angles stay 2D, as the reference's are
    (gerris_tpu/physics/tension.py:109, vof.py:763): a 3D config with
    either raises; the same 2D config carries over."""
    for dim, ok in ((3, False), (2, True)):
        jcfg = jns.NSConfig(
            grid=JGrid(level=3, dim=dim),
            u_bcs=tuple(jbc.velocity_bc(c, dim) for c in range(dim)),
            vof_tracers=(("T", jbc.FieldBC.make(
                dim, bottom=jbc.Contact(60.0) if what == "contact"
                else jbc.Neumann())),),
            **({"tension_css": (("T", 1.0),)} if what == "tension_css"
               else {"tension": (("T", 1.0),)}))
        if ok:
            assert convert.config_from_jax(jcfg).dim == 2
        else:
            with pytest.raises(NotImplementedError, match="2D"):
                convert.config_from_jax(jcfg)


@pytest.mark.parametrize("jm", [
    jmetric.MetricStretch(1.0, 0.1), jmetric.MetricLonLat(1.2),
    jmetric.MetricCubed(), jmetric.MapTransform(0.1, 0.2, 15.0),
    jmetric.MapProjection("mercator", 2.0, 10.0), None,
], ids=["stretch", "lonlat", "cubed", "transform", "projection", "none"])
def test_metric_from_jax(jm):
    """Every class of gerris_tpu/core/metric.py carries over by name and
    fields, its weights the JAX package's (1e-14); None stays None."""
    tm = convert.metric_from_jax(jm)
    if jm is None:
        assert tm is None
        return
    assert type(tm).__name__ == type(jm).__name__
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    if hasattr(jm, "weights"):
        cm, fm = jm.weights(JGrid(4))
        tcm, tfm = tm.weights(tgrid.Grid(4), "cpu")
        for a, b in zip((cm, *fm), (tcm, *tfm)):
            a = np.asarray(a)
            assert np.max(np.abs(a - b.numpy())) <= 1e-14 * np.max(np.abs(a))


def test_metric_from_jax_refuses_another_class():
    @dataclasses.dataclass(frozen=True)
    class MetricSpiral:
        turns: float = 1.0

    with pytest.raises(NotImplementedError, match="MetricSpiral"):
        convert.metric_from_jax(MetricSpiral())


@pytest.mark.parametrize("field,value", [
    ("moving_solid", True), ("moving_order", 2), ("axi", True),
    ("metric", jmetric.MetricStretch(1.0, 0.1)),
])
def test_config_from_jax_carries_slice_4b(field, value):
    """The moving solids' flag and order, the axisymmetric flag and a
    metric carry over (refused before slice 4b)."""
    kw = {field: value}
    solid = {}
    if field in ("moving_solid", "moving_order"):
        kw.update(moving_solid=True,
                  solid_phi=lambda x, y, t: x * x + y * y - 0.04)
        solid = dict(solid_phi=lambda x, y, t: x * x + y * y - 0.04)
    cfg = convert.config_from_jax(dataclasses.replace(cavity_cfg(5), **kw),
                                  **solid)
    want = convert.metric_from_jax(value) if field == "metric" else value
    assert getattr(cfg, field) == want


@pytest.mark.parametrize("field,later", [
    ("pack_faces", "ROADMAP Queue 1"), ("particle_coupling", "slice 6"),
])
def test_config_from_jax_refuses_the_later_slices(field, later):
    """The fields no slice has ported yet are refused naming their slice
    (ROADMAP Queue 1); pack_faces, a TPU layout with no counterpart,
    names the queue.  block_advect and composite_vof carry over since
    slice 5 (tests/test_torch_amr_ns.py)."""
    with pytest.raises(NotImplementedError, match=later):
        convert.config_from_jax(dataclasses.replace(cavity_cfg(5),
                                                    **{field: True}))
