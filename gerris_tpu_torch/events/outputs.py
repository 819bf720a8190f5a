"""Output and observability events (port of gerris_tpu/events/outputs.py).

Reference: src/output.c -- dynamic file names gfs_format_new:70-267,
OutputScalarNorm/Stats/Sum, OutputErrorNorm:2791 (its unbiased option),
the OutputSimulation dump:1354-1564, OutputTime, OutputTiming:772-830,
OutputLocation probes, OutputPPM through src/graphic.c:600.

An event reads the card only on the step where it fires, and then
gathers what it writes into one host read where it can (a norm's three
numbers, a raster).  A checkpoint is one ``.npz`` in the JAX package's
format (``__meta__`` JSON, one array per field, and for the composite
AMR ``name@level`` with ``__depth__``), so a checkpoint written by either
package loads in the other.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import sys
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from .events import Event
from .graphics import host
from ..core import bc as bcs_mod
from ..core.grid import center_coords
from ..ops.stencils import norms, unbiased_error


@contextlib.contextmanager
def open_output(name, mode="a"):
    """The stream of a GfsOutput file name: ``stdout`` and ``stderr`` are
    the streams themselves, anything else a file (gfs_output_open,
    src/output.c)."""
    if name == "stdout":
        yield sys.stdout
    elif name == "stderr":
        yield sys.stderr
    else:
        with open(name, mode) as f:
            yield f


def _finest_grid(sim):
    return sim.topo.grid(sim.topo.lmax) if hasattr(sim, "fine") \
        else sim.cfg.grid


def _coords(sim, like: torch.Tensor) -> tuple:
    """The finest grid's cell centres as tensors on ``like``'s device and
    dtype (copied to the device once per grid, core/grid.center_coords)."""
    return center_coords(_finest_grid(sim), like.device, like.dtype)


def _read(*values) -> list:
    """0-d tensors (and numbers) as Python floats, in one host read."""
    ts = [v for v in values if isinstance(v, torch.Tensor)]
    got = iter(torch.stack([t.to(torch.float64) for t in ts]).tolist()
               if ts else [])
    return [next(got) if isinstance(v, torch.Tensor) else float(v)
            for v in values]


def _call_solution(fn, coords, t):
    """A reference solution at the cell centres: a translated .gfs
    expression takes t as a keyword (its third positional is z), another
    callable takes (x, y[, z], t) when it has the arguments for it (the
    reference's co_argcount rule, outputs.py:168-170)."""
    if hasattr(fn, "source"):
        return fn(*coords, t=t)
    if fn.__code__.co_argcount >= len(coords) + 1:
        return fn(*coords, t)
    return fn(*coords)


def sim_field(sim, name):
    """A field at the finest resolution (a uniform Simulation, or an
    AMRSimulation through ``fine``), the reference's derived variables
    among the names (Velocity, Velocity2, Vorticity, Divergence,
    src/variable.c gfs_derived_variables) and the curvature variables of
    VariableCurvature (K and its Kmax)."""
    get = (lambda n: sim.fine(n)) if hasattr(sim, "fine") \
        else (lambda n: sim.state[n])
    if name in ("Velocity", "Velocity2", "Vorticity", "Divergence"):
        from ..models.ns import velocity_names
        from ..ops import derived
        dim = sim.cfg.grid.dim
        U = [get(n) for n in velocity_names(dim)]
        if name == "Velocity2":
            return derived.velocity2(U)
        if name == "Velocity":
            return derived.velocity_norm(U)
        grid = _finest_grid(sim)
        if name == "Vorticity":
            return derived.vorticity(U, grid, list(sim.cfg.u_bcs),
                                     t=sim.time.t)
        from ..solvers.projection import face_interpolated_velocity
        from ..ops.stencils import divergence
        uf = face_interpolated_velocity(U, grid, list(sim.cfg.u_bcs),
                                        t=sim.time.t)[0]
        # the reference's normalisation: the flux sum over h
        return divergence(uf, grid)
    cvars = getattr(sim, "curvature_vars", None) or {}
    hit = None
    for kname, (tracer, kmax) in cvars.items():
        if name == kname:
            hit = (tracer, False)
        elif name == kmax:
            hit = (tracer, True)
    if hit is not None:
        from ..physics import vof as vofm
        tracer, want_kmax = hit
        grid = _finest_grid(sim)
        fbc = dict(sim.cfg.vof_tracers).get(
            tracer, bcs_mod.default_scalar_bc(grid.dim))
        T = get(tracer)
        kap = vofm.curvature(T, grid, fbc, t=sim.time.t)
        if want_kmax:
            # |kappa| diffused with the f(1 - f) weights (diffuse_kmax,
            # src/tension.c:540-565): in 2D the one principal curvature
            k = vofm.fill_curvature_weighted(torch.abs(kap), T, niter=2)
            return torch.where(torch.isfinite(k), k, 0.0)
        kap = vofm.fill_curvature(kap, None, niter=2)
        return torch.where(torch.isfinite(kap), kap, 0.0)
    return get(name)


class OutputScalarNorm(Event):
    """L1, L2 and Linf of a field or expression at each firing
    (src/output.c OutputScalarNorm); ``v`` a name or a callable(sim)."""

    def __init__(self, v, file=None, sink: Optional[Callable] = None, **kw):
        super().__init__(name=f"OutputScalarNorm({v})", **kw)
        self.v = v
        self.file = file
        self.sink = sink
        self.rows = []

    def _value(self, sim):
        if callable(self.v):
            return self.v(sim)
        return sim_field(sim, self.v)

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        n = norms(self._value(sim))
        row = (sim.time.t, *_read(n["first"], n["second"], n["infty"]))
        self.rows.append(row)
        if self.sink:
            self.sink(sim, row)
        if self.file:
            with open_output(self.file) as f:
                f.write("%s time: %g first: %g second: %g infty: %g\n"
                        % (self.name, *row))


class OutputScalarSum(OutputScalarNorm):
    """The volume integral of a field or expression (src/output.c
    OutputScalarSum)."""

    def fire(self, sim, t, i):
        Event.fire(self, sim, t, i)
        v = self._value(sim)
        s = float(torch.sum(v)) * _finest_grid(sim).cell_volume
        self.rows.append((sim.time.t, s))
        if self.sink:
            self.sink(sim, (sim.time.t, s))
        if self.file:
            with open_output(self.file) as f:
                f.write("%s time: %g sum: %.12g\n" % (self.name, sim.time.t,
                                                       s))


class OutputErrorNorm(Event):
    """Norms of (field - reference solution), optionally unbiased or
    relative to the solution's norms (src/output.c:2791, :2849)."""

    def __init__(self, v: str, solution: Callable, unbiased: bool = False,
                 relative: bool = False, file=None, **kw):
        super().__init__(name=f"OutputErrorNorm({v})", **kw)
        self.v = v
        self.solution = solution
        self.unbiased = unbiased
        self.relative = relative
        self.file = file
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        f = sim_field(sim, self.v)
        exact = _call_solution(self.solution, _coords(sim, f), sim.time.t)
        e = f - exact
        if self.unbiased:
            e = unbiased_error(e)
        n = norms(e)
        vals = _read(n["first"], n["second"], n["infty"])
        if self.relative:
            nref = norms(exact + torch.zeros_like(e))
            ref = _read(nref["first"], nref["second"], nref["infty"])
            vals = [a / max(b, 1e-300) for a, b in zip(vals, ref)]
        row = (sim.time.t, *vals)
        self.rows.append(row)
        if self.file:
            with open_output(self.file) as f:
                f.write("%s time: %g first: %g second: %g infty: %g\n"
                        % (self.name, *row))


class OutputAdaptStats(Event):
    """Leaf counts (current, min, mean, max) and the compression against
    the uniform finest grid (src/output.c:660 GfsOutputAdaptStats)."""

    def __init__(self, file=None, **kw):
        super().__init__(name="OutputAdaptStats", **kw)
        self.file = file
        self.counts = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        if not hasattr(sim, "n_leaves"):
            n = uniform = int(np.prod(sim.cfg.grid.shape))
        else:
            n = sim.n_leaves()
            uniform = int(np.prod(_finest_grid(sim).shape))
        delta = n - self.counts[-1] if self.counts else 0
        self.counts.append(n)
        c = np.asarray(self.counts, float)
        line = ("Adaptive mesh refinement statistics\n"
                "  Cells changed: %10d\n"
                "  Number of cells\n"
                "    min: %10.0f avg: %10.3f max: %10.0f n: %10d\n"
                "  Compression vs uniform: %.3f\n"
                % (delta, c.min(), c.mean(), c.max(), len(c),
                   n / uniform))
        if self.file:
            with open_output(self.file) as f:
                f.write(line)
        else:
            sys.stderr.write(line)


class OutputBoundaries(Event):
    """Gnuplot segments of the domain's outline and of the embedded
    solid's surface (src/output.c:1607 GfsOutputBoundaries)."""

    def __init__(self, file, **kw):
        super().__init__(name="OutputBoundaries", **kw)
        self.file = file

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        grid = sim.cfg.grid
        xf = grid.axis_faces(0)
        yf = grid.axis_faces(1)
        x0, x1, y0, y1 = xf[0], xf[-1], yf[0], yf[-1]
        with open_output(format_filename(self.file, sim), "w") as f:
            for (ax, ay), (bx, by) in (((x0, y0), (x1, y0)),
                                       ((x1, y0), (x1, y1)),
                                       ((x1, y1), (x0, y1)),
                                       ((x0, y1), (x0, y0))):
                f.write("%g %g\n%g %g\n\n" % (ax, ay, bx, by))
            phi = getattr(sim.cfg, "solid_phi", None)
            if phi is not None and grid.dim == 2:
                from ..physics import vof as vofm
                T = vofm.fraction_from_levelset(
                    grid, lambda x, y: -phi(x, y), device=sim.device,
                    dtype=sim.dtype)
                segs = vofm.facets(T, grid, bcs_mod.default_scalar_bc(2))
                for sx0, sy0, sx1, sy1 in segs:
                    f.write("%g %g\n%g %g\n\n" % (sx0, sy0, sx1, sy1))


class OutputProgress(Event):
    """Progress toward Time end or iend with a wall-clock estimate
    (src/output.c GfsOutputProgress)."""

    def __init__(self, file=None, **kw):
        super().__init__(name="OutputProgress", **kw)
        self.file = file
        self.t0 = _time.time()

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        if math.isfinite(sim.time.end) and sim.time.end > 0:
            frac = sim.time.t / sim.time.end
        elif 0 < sim.time.iend < 2 ** 31:
            frac = sim.time.i / sim.time.iend
        else:
            frac = 0.0
        el = _time.time() - self.t0
        eta = el * (1.0 - frac) / frac if frac > 0 else float("inf")
        line = "%3.0f%% done, %.0f s elapsed, ETA %.0f s\n" \
            % (100.0 * frac, el, eta)
        if self.file:
            with open_output(self.file) as f:
                f.write(line)
        else:
            sys.stderr.write(line)


class OutputScalarMaxima(Event):
    """The N largest cell values of a scalar with their coordinates
    (src/output.c:2155; the exact top N, where the reference inserts
    greedily in one pass)."""

    def __init__(self, v: str, n: int = 1, file=None, **kw):
        super().__init__(name=f"OutputScalarMaxima({v})", **kw)
        self.v = v
        self.n = n
        self.file = file
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        grid = sim.cfg.grid
        flat = host(sim_field(sim, self.v)).ravel()
        cs = [c.ravel() for c in np.broadcast_arrays(*grid.centers)]
        for k, j in enumerate(np.argsort(flat)[::-1][:self.n]):
            pos = [float(c[j]) for c in cs] + [0.0] * (3 - grid.dim)
            row = (sim.time.t, k, *pos, float(flat[j]))
            self.rows.append(row)
            if self.file:
                with open_output(self.file) as fp:
                    fp.write("%s time: %g #: %d x: %g y: %g z: %g "
                             "value: %g\n" % (self.name, *row))


class OutputGrd(Event):
    """The ESRI ASCII raster of a 2D scalar (src/output.c:3404
    GfsOutputGRD), rows north to south."""

    NODATA = -9999.0

    def __init__(self, v: str, file, **kw):
        super().__init__(name=f"OutputGrd({v})", **kw)
        self.v = v
        self.file = file

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        grid = sim.cfg.grid
        assert grid.dim == 2, "GRD output is 2D"
        f = host(sim_field(sim, self.v))
        f = np.where(np.isfinite(f), f, self.NODATA)
        nx, ny = f.shape
        with open_output(format_filename(self.file, sim), "w") as fp:
            fp.write("ncols          %d\n" % nx)
            fp.write("nrows          %d\n" % ny)
            fp.write("xllcorner      %g\n" % grid.axis_faces(0)[0])
            fp.write("yllcorner      %g\n" % grid.axis_faces(1)[0])
            fp.write("cellsize       %g\n" % grid.h)
            fp.write("NODATA_value  %g\n" % self.NODATA)
            for j in range(ny - 1, -1, -1):
                fp.write(" ".join("%g" % f[ii, j] for ii in range(nx))
                         + "\n")


class OutputCorrelation(Event):
    """sum(v ref) / sum(ref^2), with the bias (the mean of v - ref)
    removed first when ``unbiased`` (src/output.c:3076; the volume
    weights are uniform and cancel)."""

    def __init__(self, v: str, solution: Callable, unbiased: bool = False,
                 file=None, **kw):
        super().__init__(name=f"OutputCorrelation({v})", **kw)
        self.v = v
        self.solution = solution
        self.unbiased = unbiased
        self.file = file
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        v = sim_field(sim, self.v)
        ref = _call_solution(self.solution, _coords(sim, v), sim.time.t)
        if self.unbiased:
            v = v - torch.mean(v - ref)
        sumref, sumvr = _read(torch.sum(ref * ref), torch.sum(v * ref))
        corr = sumvr / sumref if sumref > 0.0 else 0.0
        self.rows.append((sim.time.t, corr))
        if self.file:
            with open_output(self.file) as f:
                f.write("%s time: %g %10.3e\n"
                        % (self.name, sim.time.t, corr))


class OutputSquares(Event):
    """An OOGL dump of the cells as coloured squares (src/output.c:3181
    GfsOutputSquares)."""

    def __init__(self, v: str, file, vmin=None, vmax=None, **kw):
        super().__init__(name=f"OutputSquares({v})", **kw)
        self.v = v
        self.file = file
        self.vmin = vmin
        self.vmax = vmax

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from .graphics import write_oogl
        write_oogl(format_filename(self.file, sim), sim.cfg.grid,
                   sim_field(sim, self.v), vmin=self.vmin, vmax=self.vmax)


class OutputTime(Event):
    """The step, time, dt and wall clock (src/output.c OutputTime)."""

    def __init__(self, file=None, **kw):
        super().__init__(name="OutputTime", **kw)
        self.file = file
        self.t0 = _time.time()

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        line = ("step: %d t: %.6f dt: %g cpu: %.2f\n"
                % (sim.time.i, sim.time.t, sim.dt or 0.0,
                   _time.time() - self.t0))
        if self.file:
            with open_output(self.file) as f:
                f.write(line)
        else:
            sys.stderr.write(line)


class OutputLocation(Event):
    """Interpolated values at probe points (src/output.c OutputLocation)."""

    def __init__(self, variables, points, file=None, **kw):
        super().__init__(name="OutputLocation", **kw)
        self.variables = variables
        self.points = np.atleast_2d(np.asarray(points, float))
        self.file = file
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        vals = {v: np.atleast_1d(sim.interpolate(v, self.points))
                for v in self.variables}
        for k, pt in enumerate(self.points):
            row = [sim.time.t, *pt] + [float(vals[v][k])
                                       for v in self.variables]
            self.rows.append(row)
            if self.file:
                with open_output(self.file) as f:
                    f.write(" ".join("%g" % x for x in row) + "\n")


class OutputSimulation(Event):
    """A full checkpoint (src/output.c:1354-1564): ``save_checkpoint``
    to the file name formatted with {t} and {i}, or a .gfs name's
    re-parseable text dump and its arrays."""

    def __init__(self, file: str, **kw):
        super().__init__(name="OutputSimulation", **kw)
        self.file = file

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        save_checkpoint(self.file.format(t=sim.time.t, i=sim.time.i), sim)


def _to_numpy(v) -> np.ndarray:
    """An array of the state as numpy in its own dtype (bit for bit)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, sim):
    """The state and time as one ``.npz``: {name: array} for a uniform
    simulation; for the composite AMR every level as ``name@level`` and
    the depth map ``__depth__`` (a field stored flat, e.g. an EventStop
    difference, at the finest level).  A path ending in ``.gfs`` (the
    reference's convention: an end.gfs dump is itself a runnable file)
    writes the configuration's text with an ``InitCheckpoint`` directive
    (``_save_gfs_text``) and the arrays to ``path + ".npz"``."""
    if path.endswith(".gfs") and getattr(sim, "gfs_source", None):
        text, defines = sim.gfs_source
        _save_gfs_text(path, text, defines, sim)
        path = path + ".npz"
    amr = hasattr(sim, "topo")
    if amr:
        arrays = {f"{k}@{l}": _to_numpy(v)
                  for k, stack in sim.state.items()
                  for l, v in (stack.items() if isinstance(stack, dict)
                               else ((sim.topo.lmax, stack),))}
        arrays["__depth__"] = np.asarray(sim.depth)
    else:
        arrays = {k: _to_numpy(v) for k, v in sim.state.items()}
    meta = {"t": sim.time.t, "i": sim.time.i, "end": sim.time.end,
            "iend": min(sim.time.iend, 2 ** 31), "dtmax": sim.time.dtmax
            if math.isfinite(sim.time.dtmax) else -1.0, "amr": amr}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _save_gfs_text(path: str, text: str, defines: dict, sim):
    """The re-parseable .gfs dump: the source without an earlier
    InitCheckpoint, the -D defines as Define lines, and an InitCheckpoint
    directive after the simulation block's opening brace."""
    text = re.sub(r"^\s*InitCheckpoint\s+\S+\s*$", "", text,
                  flags=re.MULTILINE)
    # the header "NB NE GfsClass GfsBox GfsGEdge {...} {": the simulation
    # block opens at the next '{' after the GfsGEdge block
    m = re.search(r"(GfsGEdge\s*\{[^}]*\}\s*\{)", text)
    inj = f"\n    InitCheckpoint {path}.npz\n"
    text = text[:m.end()] + inj + text[m.end():] if m else inj + text
    header = "".join(f"Define {k} {v}\n" for k, v in defines.items()
                     if re.match(r"^\w+$", str(k)))
    with open(path, "w") as f:
        f.write(header + text)


def load_checkpoint(path: str, sim):
    """Restore the state and time of a checkpoint into a simulation (then
    ``run`` resumes).  The arrays go to the simulation's device and dtype;
    a composite AMR checkpoint sets the depth map and rebuilds the leaf
    masks and block tables from it."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))

    def dev(a):
        return torch.as_tensor(a).to(device=sim.device, dtype=sim.dtype) \
            .contiguous()

    if meta.get("amr"):
        state = {}
        for k in data.files:
            if k in ("__meta__", "__depth__"):
                continue
            name, l = k.rsplit("@", 1)
            state.setdefault(name, {})[int(l)] = dev(data[k])
        sim.state = state
        sim.depth = np.asarray(data["__depth__"]).astype(np.int32)
        sim._set_masks()
        if sim._use_blocks:
            sim._rebuild_blocks()
    else:
        sim.state = {k: dev(data[k]) for k in data.files if k != "__meta__"}
    sim.time.t = meta["t"]
    sim.time.i = meta["i"]
    if meta["dtmax"] > 0:
        sim.time.dtmax = meta["dtmax"]
    return sim


class OutputPPM(Event):
    """A colour-mapped PPM raster of a scalar (src/graphic.c:600
    gfs_write_ppm)."""

    def __init__(self, v, file: str, vmin=None, vmax=None, **kw):
        super().__init__(name=f"OutputPPM({v})", **kw)
        self.v = v
        self.file = file
        self.vmin = vmin
        self.vmax = vmax

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        f = self.v(sim) if callable(self.v) else sim_field(sim, self.v)
        write_ppm(self.file.format(t=sim.time.t, i=sim.time.i), host(f),
                  self.vmin, self.vmax)


def write_ppm(path: str, f, vmin=None, vmax=None):
    """The reference's jet-like colour map as a binary PPM
    (src/graphic.c); ``f`` numpy (or a tensor, copied to the host)."""
    f = host(f)
    vmin = float(np.min(f)) if vmin is None else vmin
    vmax = float(np.max(f)) if vmax is None else vmax
    x = np.clip((f - vmin) / max(vmax - vmin, 1e-300), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    img = (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)
    # the image's row 0 is the top: y up
    img = np.transpose(img, (1, 0, 2))[::-1]
    with open(path, "wb") as fp:
        fp.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        fp.write(img.tobytes())


class OutputProjectionStats(Event):
    """The norms of the MAC divergence of the face-interpolated centred
    velocity (src/output.c OutputProjectionStats)."""

    def __init__(self, file=None, **kw):
        super().__init__(name="OutputProjectionStats", **kw)
        self.file = file
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..solvers.projection import face_interpolated_velocity
        from ..ops.stencils import divergence
        from ..models import ns as _ns

        grid = sim.cfg.grid
        U = [sim_field(sim, n) for n in _ns.velocity_names(grid.dim)]
        uf = face_interpolated_velocity(U, grid, list(sim.cfg.u_bcs),
                                        t=sim.time.t)[0]
        n = norms(divergence(uf, grid))
        row = (sim.time.t, *_read(n["first"], n["second"], n["infty"]))
        self.rows.append(row)
        line = ("residual.infty: %g first: %g second: %g t: %g\n"
                % (row[3], row[1], row[2], row[0]))
        if self.file:
            with open_output(self.file) as f:
                f.write(line)
        else:
            sys.stderr.write(line)


class OutputDropletSums(Event):
    """The volume of each droplet of a VOF tracer (src/output.c
    OutputDropletSums, gfs_domain_tag_droplets)."""

    def __init__(self, v: str, file=None, **kw):
        super().__init__(name=f"OutputDropletSums({v})", **kw)
        self.v = v
        self.file = file
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..physics import droplets

        T = sim_field(sim, self.v)
        labels, n = droplets.tag_droplets(T)
        _, vol, _, _ = droplets.droplet_stats(T, labels, n, sim.cfg.grid)
        vols = host(vol)
        for k in range(n):
            row = (sim.time.t, k + 1, float(vols[k]))
            self.rows.append(row)
            if self.file:
                with open_output(self.file) as f:
                    f.write("%g %d %.12g\n" % row)


class OutputTiming(Event):
    """The simulation's timers (src/output.c:772-830 and the timer hash
    of src/domain.h:50-61): ``sim.timer_totals()`` resolves the recorded
    CUDA events, the one place they are read."""

    def __init__(self, file=None, **kw):
        super().__init__(name="OutputTiming", **kw)
        self.file = file

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        totals = sim.timer_totals() if hasattr(sim, "timer_totals") else {}
        lines = ["# Timing summary (seconds)"]
        for name, (total, count) in sorted(totals.items(),
                                           key=lambda kv: -kv[1][0]):
            lines.append("  %-28s %10.3f  (%d calls, %.2f ms/call)"
                         % (name, total, count, 1e3 * total / max(count, 1)))
        text = "\n".join(lines) + "\n"
        if self.file:
            with open_output(self.file) as f:
                f.write(text)
        else:
            sys.stderr.write(text)


def format_filename(name: str, sim) -> str:
    """A dynamic output file name: C printf patterns formatted with the
    step (%ld, %d, %i) or the time (%g, %f, %e) (src/output.c:175-213)."""
    if name is None or "%" not in name:
        return name
    out = []
    i = 0
    while i < len(name):
        ch = name[i]
        if ch == "%" and i + 1 < len(name):
            j = i + 1
            while j < len(name) and name[j] in "0123456789.-+l#":
                j += 1
            conv = name[j] if j < len(name) else ""
            spec = name[i:j + 1].replace("l", "")
            if conv in "di":
                out.append(spec % sim.time.i)
                i = j + 1
                continue
            if conv in "gfe":
                out.append(spec % sim.time.t)
                i = j + 1
                continue
        out.append(ch)
        i += 1
    return "".join(out)


class OutputSolidForce(Event):
    """The pressure and viscous force and moment of the fluid on the
    embedded solid (src/output.c:902-990, gfs_domain_solid_force
    src/domain.c:3502-3545): per mixed cell the surface's area vector
    from the closure of the cell's faces, A_s n_s = -(sum of the fluid
    face fractions times n) h, pointing into the solid; F_p = sum p A_s
    n_s, F_v = -sum mu (grad u + grad u^T) . A_s n_s."""

    def __init__(self, file=None, **kw):
        super().__init__(name="OutputSolidForce", **kw)
        self.file = file
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..physics import solid as solidm
        from ..models import ns as nsm
        cfg = sim.cfg
        grid = cfg.grid
        assert grid.dim == 2 and cfg.solid_phi is not None
        p = sim_field(sim, "P")
        a, (sx, sy) = solidm.solid_fractions(grid, cfg.solid_phi, p.device,
                                             p.dtype)
        h = grid.h
        nsx = -(sx[1:, :] - sx[:-1, :]) * h
        nsy = -(sy[:, 1:] - sy[:, :-1]) * h
        mixed = (a > 0.0) & (a < 1.0)
        x, y = _coords(sim, p)

        def total(v):
            return torch.sum(torch.where(mixed, v, 0.0))

        sums = [total(p * nsx), total(p * nsy),
                total(x * p * nsy - y * p * nsx)]
        if cfg.nu > 0.0:
            from ..ops.stencils import center_gradient
            U = [sim_field(sim, n) for n in nsm.velocity_names(2)]
            g = []
            for c in range(2):
                pad = bcs_mod.apply_bc(U[c], grid, cfg.u_bcs[c], 1,
                                       t=sim.time.t)
                g.append([center_gradient(pad, grid, ax) for ax in range(2)])
            # the deviatoric stress 2 mu D; the traction stress . n_s
            txx = 2.0 * cfg.nu * g[0][0]
            tyy = 2.0 * cfg.nu * g[1][1]
            txy = cfg.nu * (g[0][1] + g[1][0])
            sums += [-total(txx * nsx + txy * nsy),
                     -total(txy * nsx + tyy * nsy),
                     -total(x * (txy * nsx + tyy * nsy)
                            - y * (txx * nsx + txy * nsy))]
        vals = _read(*sums) + [0.0, 0.0, 0.0][:6 - len(sums)]
        fpx, fpy, mp, fvx, fvy, mv = vals
        row = (sim.time.t, fpx, fpy, fvx, fvy, mp, mv)
        self.rows.append(row)
        if self.file:
            with open_output(format_filename(self.file, sim)) as f:
                f.write(" ".join("%g" % v for v in row) + "\n")


class OutputScalarHistogram(Event):
    """A volume-weighted histogram of a field, with optional weights and
    a per-bin mean of y (src/output.c:2273-2450)."""

    def __init__(self, v, n: int = 20, vmin=None, vmax=None, w=None, y=None,
                 file=None, **kw):
        super().__init__(name=f"OutputScalarHistogram({v})", **kw)
        self.v, self.n, self.vmin, self.vmax = v, n, vmin, vmax
        self.w, self.y = w, y
        self.file = file
        self.last = None

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        vals = host(self.v(sim) if callable(self.v)
                    else sim_field(sim, self.v)).ravel()
        lo = self.vmin if self.vmin is not None else vals.min()
        hi = self.vmax if self.vmax is not None else vals.max()
        w = None if self.w is None else host(self.w(sim)).ravel()
        counts, edges = np.histogram(vals, bins=self.n, range=(lo, hi),
                                     weights=w)
        rows = [0.5 * (edges[:-1] + edges[1:]), counts]
        if self.y is not None:
            yv = host(self.y(sim)).ravel()
            ysum, _ = np.histogram(vals, bins=self.n, range=(lo, hi),
                                   weights=yv if w is None else yv * w)
            rows.append(ysum / np.maximum(counts, 1e-300))
        self.last = np.stack(rows, axis=-1)
        if self.file:
            with open_output(format_filename(self.file, sim)) as f:
                for r in self.last:
                    f.write(" ".join("%g" % x for x in r) + "\n")
                f.write("\n")


class OutputVTK(Event):
    """The state as legacy VTK (gfs_domain_write_vtk,
    src/unstructured.c:641)."""

    def __init__(self, file: str, **kw):
        super().__init__(name="OutputVTK", **kw)
        self.file = file

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from . import graphics as gfx
        grid = sim.cfg.grid
        scalars = {k: v for k, v in sim.state.items()
                   if hasattr(v, "shape") and tuple(v.shape)
                   == tuple(grid.shape)}
        vec = None
        if "U" in scalars and "V" in scalars:
            vec = {"Velocity": (scalars.pop("U"), scalars.pop("V"))}
        gfx.write_vtk(format_filename(self.file, sim), grid, scalars, vec)


class OutputStreamline(Event):
    """Streamlines seeded on a uniform grid of points (gfs_streamline_new
    and OutputStreamline, src/graphic.c:2032-2107)."""

    def __init__(self, file=None, nseeds: int = 8, **kw):
        super().__init__(name="OutputStreamline", **kw)
        self.file = file
        self.nseeds = nseeds
        self.lines = None

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from . import graphics as gfx
        grid = sim.cfg.grid
        o = grid.origin
        L = grid.shape[0] * grid.h
        n = self.nseeds
        seeds = [(o[0] + (a + 0.5) * L / n, o[1] + (b + 0.5) * L / n)
                 for a in range(n) for b in range(n)]
        self.lines = gfx.streamlines(sim.state["U"], sim.state["V"],
                                     grid, seeds)
        if self.file:
            fp, close = gfx.open_sink(self.file, sim)
            for ln in self.lines:
                for x, y in ln:
                    fp.write(f"{x} {y}\n")
                fp.write("\n")
            close()


class OutputInterface(Event):
    """The PLIC facets of a VOF tracer as segments, rows t x1 y1 x2 y2
    (src/output.c OutputInterface, gfs_vof_facet src/vof.c:2088-2158)."""

    def __init__(self, tracer: str = "T", file=None, **kw):
        super().__init__(name=f"OutputInterface({tracer})", **kw)
        self.tracer = tracer
        self.file = file
        self.segments = None

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        from ..physics import vof
        fbc = dict(sim.cfg.vof_tracers)[self.tracer]
        T = sim_field(sim, self.tracer)
        self.segments = vof.facets(T, _finest_grid(sim), fbc)
        if self.file:
            with open_output(format_filename(self.file, sim)) as f:
                for x1, y1, x2, y2 in self.segments:
                    f.write("%g %g %g %g %g\n" % (sim.time.t, x1, y1, x2,
                                                  y2))


class OutputParticleList(Event):
    """One line per live particle of a named GfsParticleList, columns t
    id x y [z] vx vy [vz] (gfs_output_particle_list_event,
    modules/particulatecommon.c:2695)."""

    def __init__(self, plist_name, file=None, sink=None, **kw):
        super().__init__(name=f"OutputParticleList({plist_name})", **kw)
        self.plist_name = plist_name
        self.file = file
        self.sink = sink
        self.rows = []

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        psys = next((p for p in sim.particle_systems
                     if getattr(p, "name", None) == self.plist_name),
                    None)
        if psys is None and sim.particle_systems:
            psys = sim.particle_systems[0]
        if psys is None:
            return
        st = psys.state
        alive = st["alive"].cpu().numpy()
        pos = host(st["pos"])
        vel = host(st["vel"])
        pid = host(st["pid"]).astype(np.int64) if "pid" in st \
            else np.arange(len(alive))
        lines = []
        for k in np.nonzero(alive)[0]:
            row = (sim.time.t, int(pid[k]), *pos[k], *vel[k])
            self.rows.append(row)
            lines.append(" ".join("%g" % x for x in row))
        if self.sink:
            self.sink(sim, self.rows)
        if self.file:
            with open_output(self.file) as f:
                f.write("\n".join(lines) + "\n")


class OutputSpectra(Event):
    """The shell-integrated power spectrum of one variable, columns k E(k)
    (GfsOutputSpectra, modules/fft.c:1168, write_spectra:1049)."""

    def __init__(self, v, file=None, sink=None, **kw):
        super().__init__(name=f"OutputSpectra({v})", **kw)
        self.v = v
        self.file = file
        self.sink = sink
        self.last = None

    def _spectrum(self, sim):
        from ..spectral import fft as sfft
        return sfft.scalar_spectrum(sim_field(sim, self.v), sim.cfg.grid)

    def fire(self, sim, t, i):
        super().fire(sim, t, i)
        k, E = self._spectrum(sim)
        self.last = (host(k), host(E))
        if self.sink:
            self.sink(sim, self.last)
        if self.file:
            with open_output(self.file) as f:
                f.write("# t = %g\n" % sim.time.t)
                for kk, ee in zip(*self.last):
                    f.write("%g %g\n" % (kk, ee))


class OutputEnergySpectra(OutputSpectra):
    """The kinetic-energy spectrum E(k) of the velocity
    (GfsOutputEnergySpectra, modules/fft.c:1476)."""

    def __init__(self, file=None, sink=None, **kw):
        Event.__init__(self, name="OutputEnergySpectra", **kw)
        self.v = "Velocity"
        self.file = file
        self.sink = sink
        self.last = None

    def _spectrum(self, sim):
        from ..spectral import fft as sfft
        from ..models.ns import velocity_names
        U = [sim_field(sim, n) for n in velocity_names(sim.cfg.grid.dim)]
        return sfft.energy_spectrum(U, sim.cfg.grid)
