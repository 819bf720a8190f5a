"""The JAX -> port carry-over: schedule floors, BCs, config fields outside
the slice, and state (dict or .npz)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
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
    ("tracers", (("T", jbc.default_scalar_bc(2), 0.0),)),
    ("solid_phi", lambda x, y: x),
    ("block_advect", True),
    ("body_force", (0.0, -1.0)),
])
def test_config_from_jax_refuses_fields_outside_slice(field, value):
    cfg = dataclasses.replace(cavity_cfg(6), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        convert.config_from_jax(cfg)


def test_fieldbc_from_jax_refuses_callables_and_navier():
    fbc = jbc.FieldBC.make(2, top=jbc.Dirichlet(lambda x, y: x))
    with pytest.raises(NotImplementedError):
        convert.fieldbc_from_jax(fbc)
    with pytest.raises(NotImplementedError):
        convert.fieldbc_from_jax(jbc.FieldBC.uniform(jbc.Navier(0.1), 2))
    per = jbc.FieldBC(((jbc.Neumann(0.5), jbc.Dirichlet(2.0)),
                       (jbc.Periodic(), jbc.Periodic())))
    got = convert.fieldbc_from_jax(per)
    assert got.is_periodic(1) and not got.is_periodic(0)
    assert got.sides[0] == (tbc.Neumann(0.5), tbc.Dirichlet(2.0))


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
