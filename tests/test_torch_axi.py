"""The axisymmetric metric (gerris_tpu_torch/models/ns.py with ``axi``: y
the radius, the cell and face factors r in the weights, the radial term
a / r^2 in component 1's viscous solve) against the JAX package on the
CPU in float64.

The step: chip_smoke.axi_cfg at level 4 with its test's solves to 1e-8
(the Poiseuille pipe of tests/test_axi.py: origin (-0.5, 0), x periodic,
G 1, nu 0.5, scheme "none") from the velocity of ``axi_state``, dt
0.2 h: the initial projection and two ns_steps on the port and on the
JAX package (eagerly, jax.disable_jit: the only JAX step of this file),
U, V, P, Pmac, Gx and Gy within 1e-10 of max after each.  The
reference's merged-cell update leaves this metric's cells alone (no cell
is small under r), so both steps compute the same update.  The pipe's
profile gate (level 5, 226 steps to steady, ~27 s on the CPU) runs on
the card in float64 (chip_smoke.axi_gate); the Poisson's order here."""
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.models import ns as jns  # noqa: E402
from gerris_tpu.physics import solid as jsolid  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

import chip_smoke  # noqa: E402
from gerris_tpu_torch.core.grid import Grid  # noqa: E402
from gerris_tpu_torch.models import ns as tns  # noqa: E402
from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.utils import convert  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jax_pins  # noqa: E402

RTOL = 1e-10
NAMES = ("U", "V", "P", "Pmac", "Gx", "Gy")
CPU = torch.device("cpu")


def axi_jcfg(level):
    """tests/test_axi.py::test_axi_poiseuille's NSConfig."""
    per = (jbc.Periodic(), jbc.Periodic())
    tol = jpoisson.MultilevelParams(tolerance=1e-8, nitermax=100)
    return jns.NSConfig(
        grid=JGrid(level, dim=2, origin=(-0.5, 0.0)),
        u_bcs=(jbc.FieldBC((per, (jbc.Neumann(), jbc.Dirichlet(0.0)))),
               jbc.FieldBC((per, (jbc.Dirichlet(0.0), jbc.Dirichlet(0.0))))),
        nu=chip_smoke.AXI_NU, beta=1.0, axi=True,
        body_force=(chip_smoke.AXI_G, None),
        advection=jns.adv.AdvectionParams(scheme="none"), projection=tol,
        approx_projection=tol,
        diffusion_params=jpoisson.MultilevelParams(tolerance=1e-8,
                                                   nitermax=30))


def axi_state(x, y):
    """The pipe's seeded velocity: U and V at the cell centres (numpy)."""
    u = 0.3 * (1.0 - y * y) + 0.05 * np.sin(2 * math.pi * x)
    v = 0.02 * np.sin(math.pi * y) * np.cos(2 * math.pi * x)
    return u, v


def _rel(ref, got):
    """max|ref - got| / max|ref|, or max|got| where ref is 0."""
    ref = np.asarray(ref)
    scale = np.max(np.abs(ref))
    return float(np.max(np.abs(ref - got.numpy())) / (scale if scale > 0
                                                      else 1.0))


def _axi_state(grid):
    x, y = (np.asarray(c) for c in grid.centers)
    st = {n: np.zeros(grid.shape) for n in NAMES}
    st["U"], st["V"] = axi_state(x, y)
    return st


def _jax_axi():
    """The JAX side of test_axi_step_matches_jax: the initial projection
    and two eager steps."""
    jcfg = axi_jcfg(4)
    dt = 0.2 * jcfg.grid.h
    js = {k: jnp.asarray(v) for k, v in _axi_state(jcfg.grid).items()}
    with jax.disable_jit():
        jout = [jns.initial_projection(js, dt, 0.0, jcfg)]
        for i in range(2):
            jout.append(jns.ns_step(jout[-1], dt, i * dt, jcfg,
                                    first_step=(i == 0), cstart=0))
    return {f"{k}_{n}": st[n] for k, st in enumerate(jout) for n in NAMES}


# the JAX package's runs pinned by tools/jax_pins.py
JAX_PINS = {"axi_step": _jax_axi}


def test_axi_step_matches_jax():
    """The initial projection and two ns_steps of the pipe at level 4 from
    the seeded velocity on the port and on the JAX package (eagerly,
    pinned by tools/jax_pins.py: axi_step): every field within 1e-10 of
    max after each, no kernel launched on the CPU."""
    ref = jax_pins.load("axi_step")
    tcfg = chip_smoke.axi_cfg(4, tol=1e-8)
    grid = tcfg.grid
    dt = 0.2 * grid.h
    rbgs.reset_launch_counts()
    tout = [tns.initial_projection(
        convert.state_from_numpy(_axi_state(grid), device="cpu"), dt, 0.0,
        tcfg)]
    for i in range(2):
        tout.append(tns.ns_step(tout[-1], dt, i * dt, tcfg,
                                first_step=(i == 0), cstart=0))
    errs = {(k, n): _rel(ref[f"{k}_{n}"], got[n])
            for k, got in enumerate(tout) for n in NAMES}
    assert max(errs.values()) <= RTOL, errs
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def test_axi_cfg_is_the_tests_pipe():
    """chip_smoke.axi_cfg with the test's tolerance is the JAX test's
    configuration carried over (the schedule aside: config_from_jax
    raises nrelax to the TPU's)."""
    ours = chip_smoke.axi_cfg(4, tol=1e-8)
    conv = convert.config_from_jax(axi_jcfg(4))
    for f in ("grid", "u_bcs", "p_bc", "nu", "beta", "advection", "axi",
              "body_force", "metric", "moving_solid"):
        assert getattr(ours, f) == getattr(conv, f), f


def test_axi_weights_match_jax():
    """_axi_metric's factors to the last bit, and a solid's fractions times
    them (as the JAX package's _weights forms them) to 1e-15; the
    reference's merged-cell update of r leaves every cell (no cell is
    small)."""
    jg, tg = JGrid(5, origin=(-0.5, 0.0)), Grid(5, origin=(-0.5, 0.0))
    cm, fm = jns._axi_metric(jg)
    tcm, tfm = tns._axi_metric(tg, CPU, torch.float64)
    assert np.array_equal(np.asarray(cm), tcm.numpy())
    for a, b in zip(fm, tfm):
        assert np.array_equal(np.asarray(a), b.numpy())
    v = np.random.default_rng(2).standard_normal(jg.shape)
    ref = jsolid.merged_cell_update(jnp.asarray(v), jnp.zeros(jg.shape),
                                    cm, fm)
    assert np.max(np.abs(np.asarray(ref) - v)) <= 1e-15

    def jphi(x, y):
        return jnp.sqrt(x * x + (y - 0.5) ** 2) - 0.2

    def tphi(x, y):
        return torch.sqrt(x * x + (y - 0.5) ** 2) - 0.2

    # the JAX package's _weights (ns.py:622-631): the fractions times r
    fa, fs = jsolid.solid_fractions(jg, jphi)
    ja, js = fa * cm, tuple(f * m for f, m in zip(fs, fm))
    cfg = tns.NSConfig(grid=tg, u_bcs=chip_smoke.walls(), solid_phi=tphi,
                       axi=True)
    w = tns._weights(cfg, torch.zeros(tg.shape, dtype=torch.float64))
    assert np.max(np.abs(np.asarray(ja) - w.a.numpy())) <= 1e-15
    for a, b in zip(js, w.s):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) <= 1e-15
    assert w.ds is not None and w.groups is not None


def test_axi_poisson_order():
    """tests/test_axi.py::test_axi_poisson_order on the port: second order
    (above 1.8 between levels 5 and 6), the error below 3e-4 at 6."""
    errs = chip_smoke.axi_poisson(CPU)
    assert math.log2(errs[-2] / errs[-1]) > chip_smoke.AXI_ORDER_MIN
    assert errs[-1] < chip_smoke.AXI_ERR_MAX


def test_axi_in_3d_and_with_nu_var_raise():
    """The metric factors are 2D (the reference's too); a variable
    viscosity beside a metric raises, as the reference's weighted solve
    would drop it."""
    from gerris_tpu_torch.core import bc
    walls3 = bc.FieldBC.uniform(bc.Dirichlet(0.0), 3)
    with pytest.raises(NotImplementedError, match="3D"):
        tns.NSConfig(grid=Grid(3, dim=3), u_bcs=(walls3,) * 3, axi=True)
    with pytest.raises(NotImplementedError, match="viscosity"):
        tns.NSConfig(grid=Grid(3), u_bcs=chip_smoke.walls(), axi=True,
                     nu_var=lambda x, y, t=0.0: 1.0 + 0.0 * x)
