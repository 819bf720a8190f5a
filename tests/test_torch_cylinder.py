"""The flow past a cylinder, the static-solid step (gerris_tpu_torch/models/
ns.py with solid_phi), against the JAX package on the CPU in float64, and
the carry-over of a solid configuration (utils/convert.config_from_jax).

The step: chip_smoke.cylinder_cfg at level 4 (48 x 16 on the 3 x 1 box,
Re 160), from U = 1, dt = 0.8 h: the initial projection and one ns_step
on the port and on the JAX package (eagerly, jax.disable_jit: the only
JAX step of this file), U, V, P, Pmac, Gx and Gy within 1e-10 of max
after each.  Both run the NSConfig defaults' schedule (adaptive
projections, diffuse's default), which the JAX package runs on the CPU as
given."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core import bc  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

RTOL = 1e-10
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")


def _jphi(x, y):
    return jnp.sqrt(x * x + y * y) - chip_smoke.CYLINDER_R


def cylinder_jcfg(level, **kw):
    """The JAX NSConfig of chip_smoke.cylinder_cfg."""
    nn = (jbc.Neumann(0.0), jbc.Neumann(0.0))
    u_bc = jbc.FieldBC(((jbc.Dirichlet(1.0), jbc.Neumann(0.0)), nn))
    v_bc = jbc.FieldBC(((jbc.Dirichlet(0.0), jbc.Neumann(0.0)),
                        (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0))))
    p_bc = jbc.FieldBC(((jbc.Neumann(0.0), jbc.Dirichlet(0.0)), nn))
    args = dict(grid=JGrid(level, dim=2, origin=(-0.5, -0.5),
                           extents=(3, 1)),
                u_bcs=(u_bc, v_bc), p_bc=p_bc, nu=chip_smoke.CYLINDER_NU,
                solid_phi=_jphi, surface_u=(0.0, 0.0))
    args.update(kw)
    return jns.NSConfig(**args)


def _rel(a, b):
    a = np.asarray(a)
    return float(np.max(np.abs(a - b.numpy())) / np.max(np.abs(a)))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_step_cache():
    """Drop this module's compiled JAX steps when it ends: other files on
    the same test worker count ns_step's jit cache entries
    (tests/test_rigid.py)."""
    yield
    jns.ns_step.clear_cache()
    jns.initial_projection.clear_cache()


def test_cylinder_step_matches_jax():
    """initial_projection and one ns_step at level 4: every field within
    1e-10 of max after each, the solid's cells at rest, and no kernel
    launched on the CPU."""
    jcfg, tcfg = cylinder_jcfg(4), chip_smoke.cylinder_cfg(4)
    grid = jcfg.grid
    st = {n: np.zeros(grid.shape) for n in NAMES}
    st["U"] = np.ones(grid.shape)
    dt = 0.8 * grid.h
    js = {k: jnp.asarray(v) for k, v in st.items()}
    with jax.disable_jit():
        j0 = jns.initial_projection(js, dt, 0.0, jcfg)
        j1 = jns.ns_step(j0, dt, 0.0, jcfg, cstart=0, first_step=True)
    rbgs.reset_launch_counts()
    ts = convert.state_from_numpy(st, device="cpu")
    t0 = tns.initial_projection(ts, dt, 0.0, tcfg)
    t1 = tns.ns_step(t0, dt, 0.0, tcfg, first_step=True, cstart=0)
    for ref, got in ((j0, t0), (j1, t1)):
        for n in NAMES:
            if float(np.max(np.abs(np.asarray(ref[n])))) > 0:
                assert _rel(ref[n], got[n]) <= RTOL, n
    a = tns._weights(tcfg, t1["U"]).a
    assert bool((t1["U"][a == 0] == 0).all() and (t1["V"][a == 0] == 0).all())
    assert float(t1["U"].abs().max()) > 1.0
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def test_cylinder_cfg_is_the_tutorial_configuration():
    """chip_smoke.cylinder_cfg, the card's configuration, is the JAX
    configuration above carried over with its level set's torch
    counterpart, field for field (up to the schedule: config_from_jax
    gives the TPU's raised nrelax; the card runs the NSConfig defaults'),
    and its cut: Re = U D / nu = 160 in a 3 x 1 box."""
    ours = chip_smoke.cylinder_cfg(4)
    conv = convert.config_from_jax(cylinder_jcfg(4),
                                   solid_phi=chip_smoke.cylinder_phi)
    for f in ("grid", "u_bcs", "p_bc", "nu", "beta", "advection",
              "solid_phi", "surface_u"):
        assert getattr(ours, f) == getattr(conv, f), f
    assert ours.grid.shape == (48, 16)
    assert 1.0 * 2 * chip_smoke.CYLINDER_R / ours.nu == pytest.approx(160.0)
    assert ours.projection == tns.NSConfig.projection
    assert ours.diffusion_params is None


def test_config_from_jax_takes_the_solid_counterparts():
    """A JAX solid config carries over only with its level set's torch
    counterpart; a callable surface velocity needs its own, a constant one
    carries over as it is."""
    with pytest.raises(NotImplementedError, match="solid_phi"):
        convert.config_from_jax(cylinder_jcfg(4))
    us = (lambda x, y: -y, 0.5)
    jcfg = cylinder_jcfg(4, surface_u=(lambda x, y: -y, 0.5))
    with pytest.raises(NotImplementedError, match=r"surface_u\[0\]"):
        convert.config_from_jax(jcfg, solid_phi=chip_smoke.cylinder_phi)
    cfg = convert.config_from_jax(jcfg, solid_phi=chip_smoke.cylinder_phi,
                                  surface_u=(us[0], None))
    assert cfg.surface_u == (us[0], 0.5)
    assert cfg.solid_phi is chip_smoke.cylinder_phi
    none = convert.config_from_jax(cylinder_jcfg(4, surface_u=None),
                                   solid_phi=chip_smoke.cylinder_phi)
    assert none.surface_u is None


@pytest.mark.parametrize("field,value,later", [
    ("pack_faces", True, "ROADMAP Queue 1"),
    ("particle_coupling", True, "slice 6"),
])
def test_config_from_jax_names_the_later_slices(field, value, later):
    """The fields of the later slices are refused naming their slices, a
    TPU layout (pack_faces) naming the queue (the metrics and moving
    solids, refused before slice 4b, carry over:
    tests/test_torch_convert.py; block_advect since slice 5)."""
    jcfg = dataclasses.replace(cylinder_jcfg(4), **{field: value})
    with pytest.raises(NotImplementedError, match=later):
        convert.config_from_jax(jcfg, solid_phi=chip_smoke.cylinder_phi)


def test_solid_in_3d_and_with_nu_var_raise():
    """A 3D solid step raises (the reference's Dirichlet surface is 2D),
    and so does a variable viscosity beside a solid (the reference does
    not compose them)."""
    walls3 = bc.FieldBC.uniform(bc.Dirichlet(0.0), 3)
    with pytest.raises(NotImplementedError, match="3D"):
        tns.NSConfig(grid=Grid(3, dim=3), u_bcs=(walls3,) * 3,
                     solid_phi=lambda x, y, z: x)
    walls = bc.FieldBC.uniform(bc.Dirichlet(0.0), 2)
    with pytest.raises(NotImplementedError, match="viscosity"):
        tns.NSConfig(grid=Grid(3), u_bcs=(walls, walls),
                     solid_phi=chip_smoke.cylinder_phi,
                     nu_var=lambda x, y, t=0.0: 1.0 + 0.0 * x)


def test_solid_context_is_built_once():
    """The geometry, the Dirichlet surface and the merge groups are built
    once per (grid, level set, device, dtype)."""
    cfg = chip_smoke.cylinder_cfg(4)
    like = torch.zeros(cfg.grid.shape, dtype=torch.float64)
    c1, c2 = tns._weights(cfg, like), tns._weights(cfg, like)
    assert c1 is c2
    c32 = tns._weights(cfg, like.float())
    assert c32 is not c1 and c32.a.dtype == torch.float32
    exact = 3.0 - math.pi * chip_smoke.CYLINDER_R ** 2
    assert float(c1.a.sum()) * cfg.grid.h ** 2 == pytest.approx(exact,
                                                               rel=1e-3)
