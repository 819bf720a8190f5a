"""The JAX -> port carry-over: schedule floors, BCs, config fields outside
the slice, and state (dict or .npz)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.core import bc as tbc  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

from test_bench_schedule import cavity_cfg  # noqa: E402


@pytest.mark.parametrize("jp,want", [
    # the bench projections: nrelax 4 -> tpu_nrelax 5, coarsest -> 40
    (jpoisson.MultilevelParams(ncycles=1, omega=1.5, tpu_nrelax=5),
     tpoisson.MultilevelParams(nrelax=5, omega=1.5, coarsest_relax=40)),
    # the bench diffusion: 1 sweep stays 1
    (jpoisson.MultilevelParams(ncycles=1, nrelax=1, tpu_nrelax=1),
     tpoisson.MultilevelParams(nrelax=1, coarsest_relax=40)),
    # the reference default: tpu_nrelax 8 raises nrelax, adaptive loop
    (jpoisson.MultilevelParams(),
     tpoisson.MultilevelParams(nrelax=8, coarsest_relax=40, ncycles=0)),
    # floors never lower an explicit schedule
    (jpoisson.MultilevelParams(ncycles=2, nrelax=12, coarsest_relax=50,
                               tpu_nrelax=3),
     tpoisson.MultilevelParams(nrelax=12, coarsest_relax=50, ncycles=2)),
    (jpoisson.MultilevelParams(ncycles=1, tpu_nrelax=30),
     tpoisson.MultilevelParams(nrelax=30, coarsest_relax=60)),
])
def test_params_from_jax_floors(jp, want):
    assert convert.params_from_jax(jp) == want


def test_params_from_jax_refuses_folds_and_maps_none():
    assert convert.params_from_jax(None).ncycles == 0
    with pytest.raises(NotImplementedError):
        convert.params_from_jax(jpoisson.MultilevelParams(fold_div=True))


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
    ("pair_advect", True),
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
