"""GTS triangulated-surface input for embedded solids (port of
gerris_tpu/physics/gts.py).

The triangulation is static per configuration, so the geometry is read
and sectioned on the host with numpy, and the solver sees a level-set
callable of torch tensors: positive inside the closed surface, the
convention of the parser's implicit shapes (the caller negates it for
the fluid side).  In 2D the surface is sectioned by the z = 0 plane into
a closed polygon (the reference flattens cut cells the same way,
src/surface.c:563-599); in 3D the whole triangle set is used with ray
parity.  Reference: src/surface.h:43-108; tools/shapes.c writes such
files; test/hexagon/hexagon.gts reads one.
"""
from __future__ import annotations

import numpy as np
import torch


def read_gts(path: str):
    """A GTS file -> (verts (nv, 3) float, faces (nf, 3) int vertex
    indices).  The format (gts_surface_read): a header ``nv ne nf
    [classes]``, nv vertex lines ``x y z``, ne edge lines ``v1 v2``
    (1-based), nf face lines ``e1 e2 e3`` (1-based edges)."""
    with open(path) as f:
        toks = f.read().split("\n")
    head = toks[0].split()
    nv, ne, nf = int(head[0]), int(head[1]), int(head[2])
    verts = np.array([[float(x) for x in toks[1 + i].split()[:3]]
                      for i in range(nv)])
    edges = np.array([[int(x) for x in toks[1 + nv + i].split()[:2]]
                      for i in range(ne)]) - 1
    faces_e = np.array([[int(x) for x in toks[1 + nv + ne + i].split()[:3]]
                        for i in range(nf)]) - 1
    # a face's vertices from its edge triple, oriented e1 -> e2 -> e3
    fv = np.empty((nf, 3), int)
    for k in range(nf):
        e1, e2, _ = edges[faces_e[k]]
        a, b = e1
        if b not in e2:
            a, b = b, a
        c = e2[0] if e2[1] == b else e2[1]
        fv[k] = (a, b, c)
    return verts, fv


def transform(verts: np.ndarray, scale=1.0, translate=(0.0, 0.0, 0.0)):
    """The reference's surface transformation (gfs_surface_transformation,
    src/surface.c): scaling about the origin, then the translation."""
    return np.asarray(verts, float) * float(scale) + np.asarray(translate,
                                                                float)


def section_z0(verts: np.ndarray, faces: np.ndarray):
    """The triangulation cut by the z = 0 plane -> segments (ns, 2, 2): each
    triangle crossing the plane gives the segment between its two edge
    crossings; a segment given twice (two triangles sharing an edge in the
    plane) is kept once, since a duplicate flips the ray parity."""
    segs = {}
    scale = float(np.abs(verts).max()) or 1.0
    eps = 1e-9 * scale
    for (i, j, k) in faces:
        tri = verts[[i, j, k]]
        z = tri[:, 2]
        pts = []
        for a, b in ((0, 1), (1, 2), (2, 0)):
            za, zb = z[a], z[b]
            if (za > 0) != (zb > 0):
                s = za / (za - zb)
                pts.append(tri[a, :2] + s * (tri[b, :2] - tri[a, :2]))
            elif za == 0.0 and zb != 0.0:
                pts.append(tri[a, :2])
        if len(pts) < 2:
            continue
        p0, p1 = pts[0], pts[1]
        if np.hypot(*(p1 - p0)) < eps:
            continue   # a vertex touching the plane
        key = tuple(sorted((tuple(np.round(p0 / eps).astype(np.int64)),
                            tuple(np.round(p1 / eps).astype(np.int64)))))
        segs.setdefault(key, (p0, p1))
    if not segs:
        raise ValueError("surface does not intersect the z=0 plane")
    return np.asarray(list(segs.values()))


def _points(*coords):
    """The coordinates as tensors of one dtype and device (float64 for
    Python numbers), broadcast together."""
    like = next((c for c in coords if isinstance(c, torch.Tensor)), None)
    dtype = torch.float64 if like is None else like.dtype
    device = None if like is None else like.device
    return torch.broadcast_tensors(*(torch.as_tensor(c, dtype=dtype,
                                                     device=device)
                                     for c in coords))


def polygon_phi(segs: np.ndarray):
    """The level-set callable phi(x, y[, z, t]) of a closed segment soup:
    positive inside (even-odd parity of upward rays), its magnitude the
    distance to the nearest segment, in the dtype of the coordinates."""
    segs = np.asarray(segs, float)

    def phi(x, y, z=0.0, t=0.0):
        x, y = _points(x, y)
        g = torch.as_tensor(segs, dtype=x.dtype, device=x.device)
        p0, p1 = g[:, 0], g[:, 1]
        d = p1 - p0
        # the guard survives float32 (1e-300 is 0 there)
        L2 = torch.clamp((d * d).sum(-1), min=1e-30)
        P = torch.stack([x, y], dim=-1)[..., None, :]
        w = P - p0
        s = torch.clamp((w * d).sum(-1) / L2, 0.0, 1.0)
        prj = p0 + s[..., None] * d
        dist = torch.sqrt(((P - prj) ** 2).sum(-1).min(dim=-1).values)
        x0, y0 = p0[:, 0], p0[:, 1]
        x1, y1 = p1[:, 0], p1[:, 1]
        xx, yy = x[..., None], y[..., None]
        straddle = (x0 <= xx) != (x1 <= xx)
        dx = x1 - x0
        ycross = y0 + (xx - x0) / torch.where(dx == 0.0, 1e-30, dx) * (y1 - y0)
        inside = (straddle & (ycross > yy)).sum(-1) % 2 == 1
        return torch.where(inside, dist, -dist)

    return phi


def polyhedron_phi(verts: np.ndarray, faces: np.ndarray):
    """The 3D level-set callable phi(x, y, z[, t]) of a closed
    triangulation: positive inside (parity of +z rays from a jittered
    origin, so that a ray never passes exactly through a mesh vertex or
    edge), its magnitude the distance to the nearest triangle."""
    tris = np.stack([verts[faces[:, 0]], verts[faces[:, 1]],
                     verts[faces[:, 2]]]).astype(float)

    def phi(x, y, z=0.0, t=0.0):
        x, y, z = _points(x, y, z)
        A, B, C = torch.as_tensor(tris, dtype=x.dtype, device=x.device)
        P = torch.stack([x, y, z], dim=-1)[..., None, :]
        ab, ac, ap = B - A, C - A, P - A
        n = torch.cross(ab, ac, dim=-1)
        nn = torch.clamp((n * n).sum(-1), min=1e-30)
        # barycentric coordinates of the projection on the plane
        u = (torch.cross(ap, ac.expand_as(ap), dim=-1) * n).sum(-1) / nn
        v = (torch.cross(ab.expand_as(ap), ap, dim=-1) * n).sum(-1) / nn
        inside_tri = (u >= 0) & (v >= 0) & (1.0 - u - v >= 0)
        plane_d = torch.abs((ap * n).sum(-1)) / torch.sqrt(nn)

        def seg_d(Q0, E):
            qp = P - Q0
            ee = torch.clamp((E * E).sum(-1), min=1e-30)
            s = torch.clamp((qp * E).sum(-1) / ee, 0.0, 1.0)
            r = qp - s[..., None] * E
            return torch.sqrt((r * r).sum(-1))

        edge_d = torch.minimum(seg_d(A, ab), torch.minimum(seg_d(A, ac),
                                                           seg_d(B, C - B)))
        dist = torch.where(inside_tri, plane_d, edge_d).min(dim=-1).values
        scale = torch.stack([A, B, C]).abs().max()
        px = x[..., None] + 1.23456789e-6 * scale
        py = y[..., None] + 2.02468135e-6 * scale
        x1, y1 = A[:, 0], A[:, 1]
        x2, y2 = B[:, 0], B[:, 1]
        x3, y3 = C[:, 0], C[:, 1]
        det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
        # vertical walls project to no xy area: they cross no z ray
        ok = torch.abs(det) > 1e-20
        dsafe = torch.where(ok, det, 1.0)
        l1 = ((y2 - y3) * (px - x3) + (x3 - x2) * (py - y3)) / dsafe
        l2 = ((y3 - y1) * (px - x3) + (x1 - x3) * (py - y3)) / dsafe
        l3 = 1.0 - l1 - l2
        in_xy = ok & (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        zc = l1 * A[:, 2] + l2 * B[:, 2] + l3 * C[:, 2]
        inside = (in_xy & (zc > z[..., None])).sum(-1) % 2 == 1
        return torch.where(inside, dist, -dist)

    return phi


def surface_phi(path: str, dim: int = 2, scale=1.0,
                translate=(0.0, 0.0, 0.0), flip: bool = False):
    """A .gts file as a level-set callable (positive inside; the caller
    negates it for the fluid side).  ``flip`` reverses the orientation."""
    verts, faces = read_gts(path)
    verts = transform(verts, scale=scale, translate=translate)
    fn = polygon_phi(section_z0(verts, faces)) if dim == 2 else \
        polyhedron_phi(verts, faces)
    if flip:
        return lambda x, y, z=0.0, t=0.0: -fn(x, y, z, t)
    return fn
