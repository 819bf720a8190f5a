"""The Krylov registry solvers of the port, ``cg`` (Jacobi-preconditioned
CG) and ``mgcg`` (flexible CG with one V-cycle as its preconditioner),
against ``gerris_tpu`` on the CPU in float64, and the gate of
tests/test_poisson.py's stiff-coefficient system on the port.

The reference ends both loops in a device while_loop; the port reads
the same condition on the host once per iteration, so it stops at the
reference's iteration: equal niter, and u within 1e-9 of max.  The
systems are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gerris_tpu.core import bc as jbc  # noqa: E402
from gerris_tpu.core.grid import Grid as JGrid  # noqa: E402
from gerris_tpu.solvers import poisson as jpoisson  # noqa: E402

from gerris_tpu_torch.ops.cuda import rbgs  # noqa: E402
from gerris_tpu_torch.solvers import poisson as tpoisson  # noqa: E402
from gerris_tpu_torch.utils.convert import (fieldbc_from_jax,  # noqa: E402
                                            grid_from_jax)

RTOL = 1e-9


def _rel(a, b, mean_free=False):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if mean_free:
        a, b = a - a.mean(), b - b.mean()
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _t(a):
    return torch.from_numpy(np.array(a))


def stiff_alpha(level, seed=7, blobs=8):
    """tests/test_poisson.py's coefficient field: a blobby 4-decade k on
    ``blobs`` x ``blobs`` blocks, harmonic means on the faces, as numpy
    face arrays."""
    n = 1 << level
    rng = np.random.default_rng(seed)
    k = np.exp(4.0 * np.log(10.0) * rng.random((blobs, blobs)))
    kf = np.kron(k, np.ones((n // blobs, n // blobs)))
    kf = kf / kf.max()
    alpha = []
    for c in range(2):
        pad = np.pad(kf, [(1, 1) if a == c else (0, 0) for a in range(2)],
                     mode="edge")
        lo = pad[tuple(slice(0, -1) if a == c else slice(None)
                       for a in range(2))]
        hi = pad[tuple(slice(1, None) if a == c else slice(None)
                       for a in range(2))]
        alpha.append(2.0 / (1.0 / lo + 1.0 / hi))
    return alpha


CASES = {
    # (BCs, face coefficients, dia)
    "neumann": (jbc.default_scalar_bc(2), False, None),
    "dirichlet_alpha": (jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2), True,
                        None),
    "mixed_dia": (jbc.FieldBC.make(2, left=jbc.Dirichlet(0.5),
                                   top=jbc.Neumann(0.2)), False, 40.0),
    "dirichlet_alpha_celldia": (jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2),
                                True, "cell"),
    "periodic_alpha": (jbc.FieldBC.uniform(jbc.Periodic(), 2), True, None),
}


def _system(case, level=5, seed=0):
    fbc, use_alpha, dia = CASES[case]
    jg = JGrid(level=level)
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal(jg.shape)
    if not any(b.kind == jbc.DIRICHLET for ax in fbc.sides for b in ax):
        rhs -= rhs.mean()
    u0 = 0.1 * rng.standard_normal(jg.shape)
    alpha = stiff_alpha(level, seed) if use_alpha else None
    if alpha is not None and fbc.is_periodic(0):
        # a periodic level's face n is its face 0
        alpha[0][-1], alpha[1][:, -1] = alpha[0][0], alpha[1][:, 0]
    if dia == "cell":
        dia = 10.0 + 10.0 * rng.random(jg.shape)
    return jg, fbc, rhs, u0, alpha, dia


def _solve_both(case, solver, tolerance, nitermax=60, level=5):
    jg, fbc, rhs, u0, alpha, dia = _system(case, level)
    mp = dict(tolerance=tolerance, nitermax=nitermax, solver=solver,
              dense_coarse_max=64)
    ju, js = jpoisson.solve(
        jnp.asarray(u0), jnp.asarray(rhs), jg, fbc,
        jpoisson.MultilevelParams(**mp),
        alpha=None if alpha is None else tuple(jnp.asarray(a)
                                               for a in alpha),
        dia=None if dia is None else jnp.asarray(dia))
    tu, ts = tpoisson.solve(
        _t(u0), _t(rhs), grid_from_jax(jg), fieldbc_from_jax(fbc),
        tpoisson.MultilevelParams(**mp),
        alpha=None if alpha is None else tuple(_t(a) for a in alpha),
        dia=dia if dia is None or isinstance(dia, float) else _t(dia))
    return ju, js, tu, ts


@pytest.mark.parametrize("solver", ["cg", "mgcg"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_krylov_matches_jax(case, solver):
    """cg and mgcg to tolerance 1e-8 at 32^2 (an 8^2 dense coarsest level
    in mgcg's V-cycle) on Neumann, Dirichlet with stiff face
    coefficients (and a cell dia), mixed inhomogeneous BCs with a scalar
    dia, and doubly periodic with face coefficients: the same niter (host
    syncs one more), u within 1e-9 of max (mean-free where the system
    is singular), the residual norms alike."""
    ju, js, tu, ts = _solve_both(case, solver, 1e-8)
    assert int(js.niter) == ts.niter > 1
    assert ts.host_syncs == ts.niter + 1
    assert _rel(ju, tu, case in ("neumann", "periodic_alpha")) <= RTOL
    assert abs(float(js.residual_after["infty"])
               - float(ts.residual_after["infty"])) \
        <= 1e-6 * float(js.residual_before["infty"])


def test_cg_stops_at_its_cap():
    """cg's cap is 20 x nitermax iterations: a tolerance it cannot reach
    in 2 x 20 ends it there, as the reference's loop does."""
    ju, js, tu, ts = _solve_both("dirichlet_alpha", "cg", 1e-14, nitermax=2)
    assert int(js.niter) == ts.niter == 40
    assert _rel(ju, tu) <= RTOL


def test_mgcg_stiff_alpha_gate():
    """tests/test_poisson.py::test_mgcg_backend_stiff_alpha on the port at
    level 6: mgcg reaches 1e-10 of max|rhs| with the 4-decade
    coefficients, in no more iterations than the adaptive multigrid, and
    the two agree; mgcg's preconditioner runs the correction's K15 route
    (its plain version on the CPU), one V-cycle per iteration and one
    more for z0."""
    level = 6
    jg = JGrid(level=level)
    g = grid_from_jax(jg)
    fbc = fieldbc_from_jax(jbc.FieldBC.uniform(jbc.Dirichlet(0.0), 2))
    alpha = tuple(_t(a) for a in stiff_alpha(level))
    x, y = (_t(c) for c in jg.centers)
    rhs = torch.sin(3 * np.pi * x) * torch.sin(2 * np.pi * y) \
        + torch.zeros(g.shape, dtype=torch.float64)
    u0 = torch.zeros(g.shape, dtype=torch.float64)
    p_mg = tpoisson.MultilevelParams(tolerance=1e-10, nitermax=60)
    p_kr = tpoisson.MultilevelParams(tolerance=1e-10, nitermax=60,
                                     solver="mgcg")
    u_mg, s_mg = tpoisson.solve(u0, rhs, g, fbc, p_mg, alpha=alpha)
    calls = []
    real = tpoisson.correction

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tpoisson.correction = spy
    try:
        u_kr, s_kr = tpoisson.solve(u0, rhs, g, fbc, p_kr, alpha=alpha)
    finally:
        tpoisson.correction = real
    r = tpoisson.residual(u_kr, rhs, g, fbc, alpha=alpha)
    scale = float(rhs.abs().max())
    assert float(r.abs().max()) < 1e-9 * scale
    assert s_kr.niter <= s_mg.niter
    assert len(calls) == s_kr.niter + 1
    assert float((u_kr - u_mg).abs().max()) < 1e-6 * float(u_mg.abs().max())
    assert all(v == 0 for v in rbgs.LAUNCHES.values())


def test_registry_solvers_take_alpha_and_dia():
    """The registry seam passes alpha and a cell dia to cg and mgcg
    (solvers/poisson.solve), as to "relax"."""
    assert set(tpoisson.SOLVER_REGISTRY) >= {"relax", "cg", "mgcg"}
    for solver in ("cg", "mgcg"):
        ju, js, tu, ts = _solve_both("dirichlet_alpha_celldia", solver,
                                     1e-6)
        assert int(js.niter) == ts.niter
        assert _rel(ju, tu) <= RTOL


@pytest.mark.parametrize("solver", ["cg", "mgcg"])
@pytest.mark.parametrize("case", ["neumann_dia", "navier"])
def test_krylov_nonsingular_keeps_the_mean(case, solver):
    """With Neumann sides and a scalar dia (a Helmholtz or diffusion
    solve), or with Navier sides, the operator is not singular: cg and
    mgcg remove no mean, so they reach the full residual's tolerance and
    agree with the adaptive multigrid solve, mean included.  (The
    reference removes the mean whenever no side is Dirichlet; ROADMAP
    Queue 3.)"""
    from gerris_tpu_torch.core import bc as tbc
    if case == "neumann_dia":
        fbc, dia = tbc.default_scalar_bc(2), 40.0
    else:
        fbc = tbc.FieldBC(((tbc.Navier(0.05), tbc.Navier(0.2)),
                           (tbc.Neumann(), tbc.Navier(0.1))))
        dia = None
    g = grid_from_jax(JGrid(level=5))
    rng = np.random.default_rng(11)
    rhs = _t(rng.standard_normal(g.shape) + 2.0)
    u0 = torch.zeros(g.shape, dtype=torch.float64)
    mp = dict(tolerance=1e-10, nitermax=60, dense_coarse_max=64)
    u_mg, _ = tpoisson.solve(u0, rhs, g, fbc,
                             tpoisson.MultilevelParams(**mp), dia=dia)
    u_kr, s_kr = tpoisson.solve(u0, rhs, g, fbc,
                                tpoisson.MultilevelParams(solver=solver,
                                                          **mp), dia=dia)
    r = tpoisson.residual(u_kr, rhs, g, fbc, dia)
    assert s_kr.niter > 1
    assert float(r.abs().max()) <= 1e-10 * float(rhs.abs().max())
    assert _rel(u_mg, u_kr) <= 1e-8
