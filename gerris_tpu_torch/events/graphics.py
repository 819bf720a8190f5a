"""Graphics and meshing exports: VTK, gnuplot/OOGL, streamlines,
isolines (port of gerris_tpu/events/graphics.py).

Reference: src/graphic.c -- gnuplot/OOGL cell and square outputs:455-599,
the PPM raster:600 (events/outputs.py), streamlines gfs_streamline_new:
2032-2107; src/unstructured.c:641 gfs_domain_write_vtk.  Everything here
is numpy on the host: a field on the card is copied to the host once per
call (``host``).
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch


def host(a) -> np.ndarray:
    """A tensor (on any device) or array as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def open_sink(file, sim=None):
    """Output sink: a filename (printf patterns formatted with step/time,
    src/output.c:70-267) or a shell pipe ``{ command }`` whose stdin
    receives the text (the reference's pipe sinks, output.c:126-150).
    Returns (file-like, close callable)."""
    from .outputs import format_filename

    s = file.strip() if isinstance(file, str) else file
    if isinstance(s, str) and s.startswith("{") and s.endswith("}"):
        proc = subprocess.Popen(s[1:-1], shell=True,
                                stdin=subprocess.PIPE, text=True)

        def close():
            proc.stdin.close()
            proc.wait()
        return proc.stdin, close
    path = format_filename(file, sim) if sim is not None else file
    f = open(path, "a")
    return f, f.close


def write_vtk(path, grid, fields: dict, vectors: dict = None):
    """Legacy-VTK structured-points file of cell-centred scalars and
    vectors (reference: gfs_domain_write_vtk, src/unstructured.c:641)."""
    shape = grid.shape
    dim = grid.dim
    n = int(np.prod(shape))
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\ngerris_tpu\nASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        if dim == 2:
            f.write(f"DIMENSIONS {shape[0]} {shape[1]} 1\n")
        else:
            f.write(f"DIMENSIONS {shape[0]} {shape[1]} {shape[2]}\n")
        o = grid.origin + (0.0,) * (3 - dim)
        f.write("ORIGIN %g %g %g\n" % (o[0] + grid.h / 2,
                                       o[1] + grid.h / 2,
                                       (o[2] + grid.h / 2) if dim == 3
                                       else 0.0))
        f.write("SPACING %g %g %g\n" % (grid.h, grid.h,
                                        grid.h if dim == 3 else 1.0))
        f.write(f"POINT_DATA {n}\n")
        for name, arr in fields.items():
            a = host(arr)
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            # VTK is x-fastest: transpose from (x, y[, z]) C-order
            np.savetxt(f, a.T.reshape(-1)[:, None], fmt="%.10g")
        for name, comps in (vectors or {}).items():
            f.write(f"VECTORS {name} double\n")
            cs = [host(c).T.reshape(-1) for c in comps]
            while len(cs) < 3:
                cs.append(np.zeros_like(cs[0]))
            np.savetxt(f, np.stack(cs, -1), fmt="%.10g")


def write_gnuplot_squares(path_or_file, grid, f):
    """Cell squares colored by a scalar, gnuplot-readable text: 5 lines
    per cell closing the square, blank-separated (reference:
    gfs_write_gnuplot / square output, src/graphic.c:455-530)."""
    a = host(f)
    h = grid.h
    x0 = np.asarray(grid.axis_faces(0))
    y0 = np.asarray(grid.axis_faces(1))
    close = None
    if hasattr(path_or_file, "write"):
        fp = path_or_file
    else:
        fp = open(path_or_file, "w")
        close = fp.close
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            v = a[i, j]
            xs = (x0[i], x0[i] + h)
            ys = (y0[j], y0[j] + h)
            fp.write(f"{xs[0]} {ys[0]} {v}\n{xs[1]} {ys[0]} {v}\n"
                     f"{xs[1]} {ys[1]} {v}\n{xs[0]} {ys[1]} {v}\n"
                     f"{xs[0]} {ys[0]} {v}\n\n")
    if close:
        close()


def write_oogl(path, grid, f, vmin=None, vmax=None):
    """Geomview OOGL CQUAD dump of a scalar (reference: gfs2oogl's
    scalar squares, tools/gfs2oogl.c + src/graphic.c OOGL writers)."""
    a = host(f)
    lo = float(a.min()) if vmin is None else vmin
    hi = float(a.max()) if vmax is None else vmax
    span = (hi - lo) or 1.0
    h = grid.h
    x0 = np.asarray(grid.axis_faces(0))
    y0 = np.asarray(grid.axis_faces(1))
    with open(path, "w") as fp:
        fp.write("LIST\n")
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                c = (a[i, j] - lo) / span
                r, g, b = _colormap(c)
                fp.write("{ CQUAD\n")
                for xs, ys in ((x0[i], y0[j]), (x0[i] + h, y0[j]),
                               (x0[i] + h, y0[j] + h), (x0[i], y0[j] + h)):
                    fp.write(f"{xs} {ys} 0 {r} {g} {b} 1\n")
                fp.write("}\n")


def _colormap(c):
    """The reference's blue-cyan-green-yellow-red jet-style map
    (src/graphic.c gfs_colormap)."""
    c = min(max(c, 0.0), 1.0)
    r = min(max(1.5 - abs(4 * c - 3.0), 0.0), 1.0)
    g = min(max(1.5 - abs(4 * c - 2.0), 0.0), 1.0)
    b = min(max(1.5 - abs(4 * c - 1.0), 0.0), 1.0)
    return r, g, b


def streamlines(U, V, grid, seeds, ds=None, max_steps=2000, both=True):
    """Streamlines of the cell-centred velocity by midpoint (RK2)
    integration with bilinear sampling (reference: gfs_streamline_new,
    src/graphic.c:2032-2107).  Returns a list of (n, 2) arrays."""
    u = host(U)
    v = host(V)
    h = grid.h
    ds = ds or 0.5 * h
    o = grid.origin

    def sample(p):
        fx = np.clip((p[0] - o[0]) / h - 0.5, 0.0, grid.shape[0] - 1.001)
        fy = np.clip((p[1] - o[1]) / h - 0.5, 0.0, grid.shape[1] - 1.001)
        i, j = int(fx), int(fy)
        wx, wy = fx - i, fy - j
        def bi(a):
            return ((1 - wx) * (1 - wy) * a[i, j] + wx * (1 - wy) * a[i + 1, j]
                    + (1 - wx) * wy * a[i, j + 1] + wx * wy * a[i + 1, j + 1])
        return np.array([bi(u), bi(v)])

    def inside(p):
        return (o[0] < p[0] < o[0] + grid.shape[0] * h and
                o[1] < p[1] < o[1] + grid.shape[1] * h)

    def trace(p0, sign):
        pts = [p0.copy()]
        p = p0.copy()
        for _ in range(max_steps):
            vel = sample(p)
            nv = np.hypot(*vel)
            if nv < 1e-12 or not inside(p):
                break
            mid = p + sign * 0.5 * ds * vel / nv
            vel2 = sample(mid)
            nv2 = np.hypot(*vel2)
            if nv2 < 1e-12:
                break
            p = p + sign * ds * vel2 / nv2
            if not inside(p):
                break
            pts.append(p.copy())
        return np.asarray(pts)

    out = []
    for s in seeds:
        p0 = np.asarray(s, float)
        fwd = trace(p0, +1.0)
        if both:
            bwd = trace(p0, -1.0)
            line = np.concatenate([bwd[::-1], fwd[1:]], 0) \
                if len(bwd) > 1 else fwd
        else:
            line = fwd
        out.append(line)
    return out


def isolines(f, grid, level):
    """Marching-squares iso-contour segments of a cell-centred scalar at
    ``level`` (the 2D analogue of the reference's isosurface extraction,
    src/graphic.c).  Returns an (nseg, 4) array of x1 y1 x2 y2."""
    a = host(f) - level
    x = np.asarray(grid.axis_centers(0))
    y = np.asarray(grid.axis_centers(1))
    segs = []
    for i in range(a.shape[0] - 1):
        for j in range(a.shape[1] - 1):
            c = [a[i, j], a[i + 1, j], a[i + 1, j + 1], a[i, j + 1]]
            pts = []
            corners = [(x[i], y[j]), (x[i + 1], y[j]),
                       (x[i + 1], y[j + 1]), (x[i], y[j + 1])]
            for k in range(4):
                v0, v1 = c[k], c[(k + 1) % 4]
                if (v0 > 0) != (v1 > 0):
                    w = v0 / (v0 - v1)
                    p0, p1 = corners[k], corners[(k + 1) % 4]
                    pts.append((p0[0] + w * (p1[0] - p0[0]),
                                p0[1] + w * (p1[1] - p0[1])))
            for k in range(0, len(pts) - 1, 2):
                segs.append((pts[k][0], pts[k][1],
                             pts[k + 1][0], pts[k + 1][1]))
    return np.asarray(segs).reshape(-1, 4)
