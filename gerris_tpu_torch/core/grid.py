"""Uniform structured grid descriptor (port of gerris_tpu/core/grid.py).

A ``Grid`` is the uniform grid at refinement ``level`` (N = 2**level cells
per axis) over the unit box centred at the origin.  Coordinates are host
numpy arrays: geometry is static, and callers move what they need to the
device of their tensors (``face_centers`` builds them on a given device).
"""
from __future__ import annotations

import dataclasses
import functools
from functools import cached_property

import numpy as np
import torch

from .device import default_device


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform grid over a box of ``extents`` unit boxes per axis
    (default: the single unit box).  Cell size h = size / 2**level."""

    level: int
    dim: int = 2
    origin: tuple = (-0.5, -0.5)
    size: float = 1.0
    extents: tuple = None

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        if len(self.origin) != self.dim:
            object.__setattr__(self, "origin", tuple(self.origin[: self.dim])
                               if len(self.origin) > self.dim
                               else tuple(self.origin) + (-0.5,) * (self.dim - len(self.origin)))
        if self.extents is None:
            object.__setattr__(self, "extents", (1,) * self.dim)

    @property
    def n(self) -> int:
        return 1 << self.level

    @property
    def h(self) -> float:
        return self.size / self.n

    @property
    def shape(self) -> tuple:
        return tuple(self.n * self.extents[a] for a in range(self.dim))

    def length(self, axis: int) -> float:
        """The box's edge length along ``axis``."""
        return self.size * self.extents[axis]

    @property
    def cell_volume(self) -> float:
        return self.h ** self.dim

    def coarser(self) -> "Grid":
        return dataclasses.replace(self, level=self.level - 1)

    def finer(self) -> "Grid":
        return dataclasses.replace(self, level=self.level + 1)

    def axis_centers(self, axis: int) -> np.ndarray:
        """Cell-centre coordinates along one axis."""
        i = np.arange(self.shape[axis])
        return self.origin[axis] + (i + 0.5) * self.h

    def axis_faces(self, axis: int) -> np.ndarray:
        """Face coordinates along one axis (n+1 values)."""
        i = np.arange(self.shape[axis] + 1)
        return self.origin[axis] + i * self.h

    @cached_property
    def centers(self) -> tuple:
        """Meshgrid (indexing='ij') of cell-centre coordinates, numpy."""
        axes = [self.axis_centers(a) for a in range(self.dim)]
        return tuple(np.meshgrid(*axes, indexing="ij"))

    def face_centers(self, axis: int, device=None,
                     dtype=torch.float64) -> tuple:
        """Meshgrid (indexing='ij') of the centres of the faces normal to
        ``axis`` (n + 1 along it, n along the others), as tensors of
        ``dtype`` on ``device`` (the CUDA card by default), formed from
        the float64 coordinates."""
        device = default_device(device)
        axes = [self.axis_faces(a) if a == axis else self.axis_centers(a)
                for a in range(self.dim)]
        return tuple(torch.as_tensor(c, dtype=torch.float64, device=device)
                     .to(dtype) for c in np.meshgrid(*axes, indexing="ij"))

    def boundary_coord(self, axis: int, side: int) -> float:
        """Physical coordinate of the domain boundary plane."""
        return self.origin[axis] + (self.length(axis) if side == 1 else 0.0)

    def face_shape(self, axis: int) -> tuple:
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)


@functools.lru_cache(maxsize=8)
def vertex_coords(grid: Grid, device, dtype) -> tuple:
    """The meshgrid (indexing='ij') of a 2D grid's cell vertices, (n0 + 1,
    n1 + 1) each, as tensors of ``dtype`` on the torch.device ``device``,
    copied from the host once per grid, device and dtype: a moving solid
    samples its level set there every step, and a copy from the host's
    memory each time would make the card wait."""
    X, Y = np.meshgrid(grid.axis_faces(0), grid.axis_faces(1), indexing="ij")
    return (torch.as_tensor(X, dtype=dtype, device=device),
            torch.as_tensor(Y, dtype=dtype, device=device))


@functools.lru_cache(maxsize=8)
def center_coords(grid: Grid, device, dtype) -> tuple:
    """``grid.centers`` as tensors of ``dtype`` on the torch.device
    ``device``, copied from the host once per grid, device and dtype."""
    return tuple(torch.as_tensor(c, dtype=dtype, device=device)
                 for c in grid.centers)
