"""The GfsVariable* classes as state-updating events (port of
gerris_tpu/events/variables.py).

Reference: src/variable.c and src/tension.c:390-760 (the registry
src/init.c:166-189: Average, Function, Position, Distance, Age,
Residual, ...).  Each is an Event that writes one entry of
``sim.state`` when it fires, so the outputs and the adaptation read them
as fields.  GfsVariableAge is a tracer with a unit source
(``NSConfig.tracers`` entry ("Age", bc, 0.0, 1.0)).  The fields stay on
the simulation's device; VariableDistance and EventHarmonic compute on
the host and copy their result back once.
"""
from __future__ import annotations

import numpy as np
import torch

from .events import Event
from .graphics import host


def _tiny(a: torch.Tensor) -> float:
    """The smallest normal number of a's dtype: the reference's guard of
    1e-300 is 0 in float32 (variables.py:113-125)."""
    return torch.finfo(a.dtype).tiny


class VariableFunction(Event):
    """state[name] = fn(sim) at every firing (GfsVariableFunction,
    src/variable.c: an Init that is always on)."""

    def __init__(self, name: str, fn, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariableFunction({name})", **kw)
        self.var = name
        self.fn = fn

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        sim.state[self.var] = self.fn(sim)


class VariableTurbulentViscosity(Event):
    """The LES eddy viscosity nu_t from the resolved velocity gradients
    at every firing (GfsVariableTurbulentViscosity,
    modules/turbulence.c:934-1131).

    model="smagorinsky": nu_t = (Cs h)^2 sqrt(2 S_ij S_ij), S_ij = (d_i u_j
    + d_j u_i) / 2 (get_smagorinsky_viscosity, :965-981).
    model="sigma": Nicoud's sigma model, nu_t = (Cs h)^2 sigma3 (sigma1 -
    sigma2)(sigma2 - sigma3) / sigma1^2 from the singular values of the
    velocity gradient (get_sigma_viscosity, :983-1054).

    A SourceViscosity expression reads it by name, e.g. ``SourceViscosity
    (MU + NUT)``.  On an AMRSimulation the field is computed at the
    finest level and stored as a level stack, its coarser levels the
    restrictions (the reference's variables.py:128-131 stores it flat,
    guarded on a ``restrict_stack`` no simulation has, and the composite
    step then reads rows of it as levels)."""

    def __init__(self, name: str, cs: float = 0.17,
                 model: str = "smagorinsky", **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariableTurbulentViscosity({name})", **kw)
        self.var = name
        self.cs = float(cs)
        self.model = model

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..core import bc as bcs
        from ..models.ns import velocity_names

        amr = hasattr(sim, "fine")
        grid = sim.topo.grid(sim.topo.lmax) if amr else sim.cfg.grid
        dim = grid.dim
        U = [sim.fine(n) if amr else sim.state[n]
             for n in velocity_names(dim)]
        h = grid.h
        pads = [bcs.apply_bc(u, grid, sim.cfg.u_bcs[k], 1, t=t)
                for k, u in enumerate(U)]

        def ctr(p, ax):
            lo = [slice(1, -1)] * dim
            hi = [slice(1, -1)] * dim
            lo[ax] = slice(0, -2)
            hi[ax] = slice(2, None)
            return (p[tuple(hi)] - p[tuple(lo)]) / (2.0 * h)

        # g[i][j] = d u_i / d x_j, centred
        g = [[ctr(pads[i_], j) for j in range(dim)] for i_ in range(dim)]
        cs2h2 = (self.cs * h) ** 2
        if self.model == "smagorinsky":
            s2 = sum((0.5 * (g[a][b] + g[b][a])) ** 2
                     for a in range(dim) for b in range(dim))
            nut = cs2h2 * torch.sqrt(2.0 * s2)
        else:
            nut = cs2h2 * _sigma_operator(g, dim)
        if amr:
            from ..solvers import poisson
            stack = {sim.topo.lmax: nut}
            for l in range(sim.topo.lmax - 1, sim.topo.lmin - 1, -1):
                stack[l] = poisson.restrict(stack[l + 1])
            sim.state[self.var] = stack
        else:
            sim.state[self.var] = nut


def _sigma_operator(g, dim: int) -> torch.Tensor:
    """sigma3 (sigma1 - sigma2)(sigma2 - sigma3) / sigma1^2 of G = g^T g
    from its invariants (the closed forms of modules/turbulence.c:
    1005-1049); 0 where the invariants give no real roots."""
    G = [[sum(g[k][a] * g[k][b] for k in range(dim)) for b in range(dim)]
         for a in range(dim)]
    inv1 = sum(G[a][a] for a in range(dim))
    G2tr = sum(sum(G[a][k] * G[k][a] for k in range(dim))
               for a in range(dim))
    inv2 = (inv1 ** 2 - G2tr) / 2.0
    if dim == 2:
        # diag(G, 0): a 2D gradient's third singular value is 0 (the C's
        # 2D branch takes the 2x2 det, unreachable: model_type is never
        # parsed, modules/turbulence.c:1073-1086)
        inv3 = torch.zeros_like(inv1)
    else:
        inv3 = (G[0][0] * (G[1][1] * G[2][2] - G[1][2] * G[2][1])
                - G[0][1] * (G[1][0] * G[2][2] - G[1][2] * G[2][0])
                + G[0][2] * (G[1][0] * G[2][1] - G[1][1] * G[2][0]))
    tiny = _tiny(inv1)
    a1 = torch.clamp(inv1 ** 2 / 9.0 - inv2 / 3.0, min=0.0)
    a2 = inv1 ** 3 / 27.0 - inv1 * inv2 / 6.0 + inv3 / 2.0
    a132 = torch.pow(torch.clamp(a1, min=tiny), 1.5)
    a3 = torch.arccos(torch.clamp(a2 / torch.clamp(a132, min=tiny),
                                  -1.0, 1.0)) / 3.0
    sq = torch.sqrt(a1)
    s1 = torch.sqrt(torch.clamp(inv1 / 3.0 + 2 * sq * torch.cos(a3),
                                min=0.0))
    s2 = torch.sqrt(torch.clamp(
        inv1 / 3.0 - 2 * sq * torch.cos(np.pi / 3.0 + a3), min=0.0))
    s3 = torch.sqrt(torch.clamp(
        inv1 / 3.0 - 2 * sq * torch.cos(np.pi / 3.0 - a3), min=0.0))
    dsig = torch.where(s1 > 0.0, s3 * (s1 - s2) * (s2 - s3)
                       / torch.clamp(s1 ** 2, min=tiny), 0.0)
    return torch.where((a1 > 0.0) & (a2 < a132), dsig, 0.0)


class VariableAverage(Event):
    """The running time average of a field over the firings so far
    (GfsVariableAverage, src/variable.c: A_n = A_{n-1} + (v - A_{n-1}) /
    n)."""

    def __init__(self, name: str, of: str, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariableAverage({name})", **kw)
        self.var = name
        self.of = of
        self.n = 0

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        v = sim.state[self.of]
        self.n += 1
        prev = sim.state.get(self.var)
        if prev is None or self.n == 1:
            sim.state[self.var] = v
        else:
            sim.state[self.var] = prev + (v - prev) / self.n


class VariablePosition(Event):
    """A coordinate of the VOF interface's centroid in the interface
    cells, NODATA elsewhere (GfsVariablePosition,
    src/tension.c:638-760)."""

    NODATA = 1e30

    def __init__(self, name: str, tracer: str, component: int, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariablePosition({name})", **kw)
        self.var = name
        self.tracer = tracer
        self.component = component

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..core.grid import center_coords
        from ..physics import vof
        grid = sim.cfg.grid
        fbc = dict(sim.cfg.vof_tracers)[self.tracer]
        T = sim.state[self.tracer]
        mx, my = vof.normals(T, grid, fbc, t=sim.time.t)
        alpha = vof.reconstruct_alpha(T, mx, my)
        sx, sy = _segment_midpoint(mx, my, alpha)
        x, y = center_coords(grid, T.device, T.dtype)
        pos = (x + (sx - 0.5) * grid.h) if self.component == 0 \
            else (y + (sy - 0.5) * grid.h)
        ifc = (T > vof.FULL_TOL) & (T < 1.0 - vof.FULL_TOL)
        sim.state[self.var] = torch.where(ifc, pos, self.NODATA)


def _segment_midpoint(mx, my, alpha):
    """The midpoint of {mx sx + my sy = alpha} cut by the unit square; a
    degenerate cell gives the cell centre."""
    eps = 1e-30
    cands = []
    for x0 in (0.0, 1.0):
        y0 = (alpha - mx * x0) / torch.where(my.abs() < eps, eps, my)
        cands.append((torch.full_like(y0, x0), y0, (y0 >= 0.0) & (y0 <= 1.0)))
    for y0 in (0.0, 1.0):
        x0 = (alpha - my * y0) / torch.where(mx.abs() < eps, eps, mx)
        cands.append((x0, torch.full_like(x0, y0), (x0 >= 0.0) & (x0 <= 1.0)))
    sx = sy = w = 0.0
    for cx, cy, ok in cands:
        sx = sx + torch.where(ok, cx, 0.0)
        sy = sy + torch.where(ok, cy, 0.0)
        w = w + ok.to(mx.dtype)
    w = torch.clamp(w, min=1.0)
    deg = w < 2.0
    return torch.where(deg, 0.5, sx / w), torch.where(deg, 0.5, sy / w)


class VariableDistance(Event):
    """The signed distance to the VOF interface (GfsVariableDistance,
    src/variable.c): the nearest facet point on the host, the sign from
    the fraction."""

    def __init__(self, name: str, tracer: str, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariableDistance({name})", **kw)
        self.var = name
        self.tracer = tracer

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from scipy.spatial import cKDTree
        from ..physics import vof
        grid = sim.cfg.grid
        fbc = dict(sim.cfg.vof_tracers)[self.tracer]
        Tt = sim.state[self.tracer]
        segs = vof.facets(Tt, grid, fbc, t=sim.time.t)
        if segs.shape[0] == 0:
            sim.state[self.var] = torch.full_like(Tt, 1e30)
            return
        x, y = np.broadcast_arrays(*grid.centers)
        pts = np.concatenate([segs[:, :2], segs[:, 2:],
                              0.5 * (segs[:, :2] + segs[:, 2:])], 0)
        d, _ = cKDTree(pts).query(np.stack([x.ravel(), y.ravel()], -1))
        sign = np.where(host(Tt) > 0.5, 1.0, -1.0)
        sim.state[self.var] = torch.as_tensor(
            sign * d.reshape(grid.shape), dtype=Tt.dtype, device=Tt.device)


class EventSum(Event):
    """The time integral of a field or expression into a state variable
    (GfsEventSum, src/event.c: sv += v dt)."""

    def __init__(self, name: str, of, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"EventSum({name})", **kw)
        self.var = name
        self.of = of
        self._last_t = None

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        v = self.of(sim) if callable(self.of) else sim.state[self.of]
        dt = 0.0 if self._last_t is None else sim.time.t - self._last_t
        self._last_t = sim.time.t
        prev = sim.state.get(self.var)
        sim.state[self.var] = (v * 0.0 if prev is None else prev) + v * dt


class EventHarmonic(Event):
    """A running least-squares fit v ~ Z + sum_k A_k sin(w_k t) + B_k
    cos(w_k t) at the given frequencies (GfsEventHarmonic, src/event.c):
    the normal matrix on the host, the right-hand sides on the device."""

    def __init__(self, v: str, omegas, prefix: str = None, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"EventHarmonic({v})", **kw)
        self.v = v
        self.om = list(omegas)
        self.prefix = prefix or v
        self.M = None
        self.rhs = None

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        tt = sim.time.t
        b = np.asarray([1.0] + [f(w * tt) for w in self.om
                                for f in (np.sin, np.cos)])
        n = b.size
        if self.M is None:
            self.M = np.zeros((n, n))
            self.rhs = [0.0] * n
        self.M += np.outer(b, b)
        v = sim.state[self.v]
        for k in range(n):
            self.rhs[k] = self.rhs[k] + float(b[k]) * v
        if np.linalg.matrix_rank(self.M) == n:
            Minv = np.linalg.inv(self.M)
            names = [f"{self.prefix}Z"] + [
                f"{self.prefix}{f}{k}" for k in range(len(self.om))
                for f in ("A", "B")]
            for r, nm in enumerate(names):
                acc = 0.0
                for c in range(n):
                    acc = acc + float(Minv[r, c]) * self.rhs[c]
                sim.state[nm] = acc


class EventScript(Event):
    """A shell command at each firing, with the time and step exported as
    $GFS_T and $GFS_I (GfsEventScript, src/event.c)."""

    def __init__(self, command: str, **kw):
        super().__init__(name="EventScript", **kw)
        self.command = command
        self.returncodes = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        import os
        import subprocess
        env = dict(os.environ, GFS_T=str(sim.time.t), GFS_I=str(sim.time.i))
        self.returncodes.append(
            subprocess.call(self.command, shell=True, env=env))


class EventFilter(Event):
    """The (1,2,1)/4 tensor filter applied to a variable on schedule
    (GfsEventFilter, src/event.c)."""

    def __init__(self, v: str, scale: int = 1, **kw):
        super().__init__(name=f"EventFilter({v})", **kw)
        self.v = v
        self.scale = scale

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..models.ns import filtered
        from ..core import bc as bcs
        fbc = bcs.default_scalar_bc(sim.cfg.grid.dim)
        sim.state[self.v] = filtered(sim.state[self.v], sim.cfg.grid,
                                     fbc, self.scale, t=sim.time.t)


class RemoveDroplets(Event):
    """The VOF droplets below a cell count removed (GfsRemoveDroplets,
    src/event.c, gfs_domain_remove_droplets src/domain.c:3727)."""

    def __init__(self, tracer: str, min_cells: int, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"RemoveDroplets({tracer})", **kw)
        self.tracer = tracer
        self.min_cells = min_cells

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..physics.droplets import remove_droplets
        sim.state[self.tracer] = remove_droplets(
            sim.state[self.tracer], sim.cfg.grid, self.min_cells)


def init_vorticity(omega, grid, u_bcs=None, params=None):
    """(U, V) whose curl is ``omega`` through the stream function: lap psi
    = -omega with psi = 0 on the walls, u = dpsi/dy, v = -dpsi/dx
    (GfsInitVorticity, src/init.c); on omega's device and dtype."""
    from ..core import bc as bcs
    from ..solvers import poisson
    fbc = bcs.FieldBC.uniform(bcs.Dirichlet(0.0), grid.dim)
    params = params or poisson.MultilevelParams(tolerance=1e-9,
                                               nitermax=60)
    psi, _ = poisson.solve(torch.zeros_like(omega), -omega, grid, fbc,
                           params)
    pad = bcs.apply_bc(psi, grid, fbc, 1)
    h = grid.h
    U = (pad[1:-1, 2:] - pad[1:-1, :-2]) / (2 * h)
    V = -(pad[2:, 1:-1] - pad[:-2, 1:-1]) / (2 * h)
    return U, V


class VariableLaplacian(Event):
    """state[name] = the Laplacian of a field (or of fn(sim)) at every
    firing (GfsVariableLaplacian, src/variable.c:1278-1330: the BC ghosts,
    then the solver's operator)."""

    def __init__(self, name: str, of, fbc=None, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariableLaplacian({name})", **kw)
        self.var = name
        self.of = of
        self.fbc = fbc

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..core import bc as bcs
        from ..ops.stencils import laplacian
        grid = sim.cfg.grid
        u = self.of(sim) if callable(self.of) else sim.state[self.of]
        fbc = self.fbc or bcs.default_scalar_bc(grid.dim)
        sim.state[self.var] = laplacian(
            bcs.apply_bc(u, grid, fbc, t=sim.time.t), grid)


class VariablePoisson(Event):
    """state[name] solves lap(v) = rhs at every firing
    (GfsVariablePoisson, src/variable.c:1127-1240); without a Dirichlet
    side the rhs's mean is removed and the solution's zeroed."""

    def __init__(self, name: str, rhs, params=None, fbc=None, **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariablePoisson({name})", **kw)
        self.var = name
        self.rhs = rhs
        self.params = params
        self.fbc = fbc
        self.stats = None

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..core import bc as bcs
        from ..solvers import poisson
        grid = sim.cfg.grid
        r = self.rhs(sim) if callable(self.rhs) else sim.state[self.rhs]
        r = torch.broadcast_to(r, grid.shape).contiguous()
        fbc = self.fbc or bcs.default_scalar_bc(grid.dim)
        neumann = not bcs.has_kind(fbc, bcs.DIRICHLET)
        if neumann:
            r = r - torch.mean(r)
        u0 = sim.state.get(self.var)
        u0 = torch.zeros_like(r) if u0 is None else u0
        sol, self.stats = poisson.solve(u0, r, grid, fbc,
                                        self.params or
                                        poisson.MultilevelParams(),
                                        t=sim.time.t)
        if neumann:
            sol = sol - torch.mean(sol)
        sim.state[self.var] = sol


class VariableResidual(Event):
    """The MAC divergence of the face-interpolated centred velocity as a
    field (GfsVariableResidual, src/variable.c)."""

    def __init__(self, name: str = "Res", **kw):
        kw.setdefault("istep", 1)
        super().__init__(name=f"VariableResidual({name})", **kw)
        self.var = name

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..ops.stencils import divergence
        from ..solvers import projection as proj
        cfg = sim.cfg
        grid = cfg.grid
        U = [sim.state[n] for n in ("U", "V", "W")[:grid.dim]]
        uf = proj.face_interpolated_velocity(U, grid, list(cfg.u_bcs),
                                             t=sim.time.t)[0]
        sim.state[self.var] = divergence(uf, grid)
