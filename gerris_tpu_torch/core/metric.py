"""Orthogonal metrics and coordinate mappings (port of gerris_tpu/core/
metric.py).

A metric gives one area factor ``cm`` per cell and one length factor per
face, ``(fmx, fmy)`` (reference: src/metric.c, GfsMetricStretch,
GfsMetricLonLat, GfsMetricCubed, through the domain's metric hooks
src/domain.h:94-110).  models/ns._weights multiplies them into the same
cell and face weights as a solid's fractions, as the reference's
gfs_poisson_coefficients takes both (src/poisson.c:756-901); the
axisymmetric metric (GfsAxi) is models/ns._axi_metric.

``weights(grid, device, dtype)`` returns the factors as tensors of
``dtype`` on ``device`` (the CUDA card by default), computed there in
float64 and cast.  The mappings (MapTransform, MapProjection) act on
floats or torch tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .device import default_device
from .grid import Grid


def _axis(grid: Grid, axis: int, faces: bool, device) -> torch.Tensor:
    x = grid.axis_faces(axis) if faces else grid.axis_centers(axis)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _out(cm, fmx, fmy, grid: Grid, dtype) -> tuple:
    """The factors broadcast to the cell and face shapes, contiguous, in
    ``dtype``."""
    def shaped(v, shape):
        return torch.broadcast_to(v, shape).to(dtype).contiguous()
    return shaped(cm, grid.shape), (shaped(fmx, grid.face_shape(0)),
                                    shaped(fmy, grid.face_shape(1)))


@dataclasses.dataclass(frozen=True)
class MetricStretch:
    """Constant anisotropic stretching: physical dx = sx h, dy = sy h
    (GfsMetricStretch, src/metric.c; test/lake takes sy = 0.1).  cm = sx
    sy; a face's weight is its length over the normal scale (poisson_coeff,
    src/poisson.c:772): x faces sy / sx, y faces sx / sy."""
    sx: float = 1.0
    sy: float = 1.0

    def weights(self, grid: Grid, device=None, dtype=torch.float64):
        device = default_device(device)

        def full(v):
            return torch.full((), v, dtype=torch.float64, device=device)
        return _out(full(self.sx * self.sy), full(self.sy / self.sx),
                    full(self.sx / self.sy), grid, dtype)


@dataclasses.dataclass(frozen=True)
class MetricLonLat:
    """The longitude-latitude sphere: x = lon, y = lat, domain units times
    ``scale`` in radians.  cm = cos(lat); lon faces 1 / cos(lat), lat
    faces cos(lat) at the face (src/poisson.c:772 with src/metric.c's
    lon-lat face and scale metrics; GfsMetricLonLat)."""
    scale: float = math.pi          # domain [-0.5, 0.5] -> +-pi/2 lat

    def weights(self, grid: Grid, device=None, dtype=torch.float64):
        device = default_device(device)
        lat_c = _axis(grid, 1, False, device) * self.scale
        lat_f = _axis(grid, 1, True, device) * self.scale
        return _out(torch.cos(lat_c)[None, :],
                    1.0 / torch.cos(lat_c)[None, :],
                    torch.cos(lat_f)[None, :], grid, dtype)


@dataclasses.dataclass(frozen=True)
class MetricCubed:
    """One gnomonic cubed-sphere panel: [-0.5, 0.5]^2 onto a sixth of the
    sphere by X = tan(a x), Y = tan(a y), a = pi/2, with discrete factors
    as the reference forms them from the projected cells (GfsMetricCubed,
    src/metric.c): cm the spherical quad's area over h^2, a face's weight
    its arc over the arc between the two cell centres beside it (the
    boundary faces take their one neighbour's).  One panel only: the six
    panels' topology wants the rotated box graph."""
    a: float = math.pi / 2.0

    def _project(self, x, y):
        X = torch.tan(self.a * x)
        Y = torch.tan(self.a * y)
        rho = torch.sqrt(1.0 + X * X + Y * Y)
        return torch.stack([1.0 / rho, X / rho, Y / rho], -1)

    @staticmethod
    def _arc(p, q):
        cross = torch.linalg.cross(p, q, dim=-1)
        s = torch.sqrt(torch.sum(cross * cross, -1))
        c = torch.sum(p * q, -1)
        return torch.atan2(s, c)

    def weights(self, grid: Grid, device=None, dtype=torch.float64):
        device = default_device(device)
        h = grid.h
        corners = self._project(*torch.meshgrid(
            _axis(grid, 0, True, device), _axis(grid, 1, True, device),
            indexing="ij"))                          # (nx + 1, ny + 1, 3)
        centers = self._project(*torch.meshgrid(
            _axis(grid, 0, False, device), _axis(grid, 1, False, device),
            indexing="ij"))                          # (nx, ny, 3)

        def tri_area(p, q, r):
            # the spherical excess of one triangle
            num = torch.abs(torch.sum(
                p * torch.linalg.cross(q, r, dim=-1), -1))
            den = (1.0 + torch.sum(p * q, -1) + torch.sum(q * r, -1)
                   + torch.sum(r * p, -1))
            return 2.0 * torch.atan2(num, den)

        p00, p10 = corners[:-1, :-1], corners[1:, :-1]
        p11, p01 = corners[1:, 1:], corners[:-1, 1:]
        cm = (tri_area(p00, p10, p11) + tri_area(p00, p11, p01)) / (h * h)
        cdist_x = self._arc(centers[:-1, :], centers[1:, :])
        cdist_x = torch.cat([cdist_x[:1], cdist_x, cdist_x[-1:]], 0)
        fmx = self._arc(corners[:, :-1], corners[:, 1:]) / cdist_x
        cdist_y = self._arc(centers[:, :-1], centers[:, 1:])
        cdist_y = torch.cat([cdist_y[:, :1], cdist_y, cdist_y[:, -1:]], 1)
        fmy = self._arc(corners[:-1, :], corners[1:, :]) / cdist_y
        return _out(cm, fmx, fmy, grid, dtype)


@dataclasses.dataclass(frozen=True)
class MapTransform:
    """A translation and a rotation (degrees, about z) of positions before
    user functions and solids see them (GfsMapTransform, src/map.c)."""
    tx: float = 0.0
    ty: float = 0.0
    angle: float = 0.0

    def forward(self, x, y):
        a = math.radians(self.angle)
        ca, sa = math.cos(a), math.sin(a)
        return ca * x - sa * y + self.tx, sa * x + ca * y + self.ty

    def inverse(self, x, y):
        a = math.radians(self.angle)
        ca, sa = math.cos(a), math.sin(a)
        xr, yr = x - self.tx, y - self.ty
        return ca * xr + sa * yr, -sa * xr + ca * yr


def _tensor(v):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(v, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class MapProjection:
    """A cartographic projection between (lon, lat) in degrees and model
    (x, y), the proj4 module's common cases (modules/map.c,
    GfsMapProjection): "mercator" or "lonlat" (plate carree), ``L``
    model units per radian.  Takes floats or tensors, returns tensors."""
    kind: str = "lonlat"
    L: float = 1.0
    lon0: float = 0.0

    def forward(self, lon, lat):
        lam = torch.deg2rad(_tensor(lon) - self.lon0)
        phi = torch.deg2rad(_tensor(lat))
        if self.kind == "mercator":
            return self.L * lam, self.L * torch.log(
                torch.tan(math.pi / 4.0 + phi / 2.0))
        return self.L * lam, self.L * phi

    def inverse(self, x, y):
        lam = _tensor(x) / self.L
        y = _tensor(y)
        if self.kind == "mercator":
            phi = 2.0 * torch.atan(torch.exp(y / self.L)) - math.pi / 2.0
        else:
            phi = y / self.L
        return torch.rad2deg(lam) + self.lon0, torch.rad2deg(phi)
