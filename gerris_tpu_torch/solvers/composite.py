"""The composite mesh's host-side descriptor and wrappers (port of
gerris_tpu/solvers/composite.py).

``CompositeGrid`` holds the leaf masks per level as host numpy (hashable:
bytes), built from leaf masks, from a per-finest-cell depth map with the
2:1 grading fixpoint (gfs_domain_reshape, src/adaptive.c:998-1022), or
from a refinement indicator (the static GfsRefine, src/refine.c:115).
The numerics are solvers/amr.py's; ``leaf_arrays`` uploads the masks to
the device once.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict

import numpy as np
import torch

from ..core.device import default_device, upload
from ..core.grid import Grid
from ..core import bc as bcs
from . import amr, poisson
from .amr import Topo


@dataclasses.dataclass(frozen=True)
class CompositeGrid:
    """Host-side multi-level mesh: per level (shape, leaf bytes, active
    bytes), active = leaf | covered by finer."""
    base: Grid                  # the grid at lmin
    lmin: int
    lmax: int
    _masks: tuple

    @staticmethod
    def build(base: Grid, leaf_masks: Dict[int, np.ndarray]
              ) -> "CompositeGrid":
        lmin, lmax = min(leaf_masks), max(leaf_masks)
        packed = [None] * (lmax - lmin + 1)
        cover = None
        for l in range(lmax, lmin - 1, -1):
            m = np.asarray(leaf_masks[l], bool)
            act = m if cover is None else (m | cover)
            packed[l - lmin] = (m.shape, m.tobytes(), act.tobytes())
            cover = _pool_any_np(act, base.dim)
        return CompositeGrid(base=dataclasses.replace(base, level=lmin),
                             lmin=lmin, lmax=lmax, _masks=tuple(packed))

    @staticmethod
    def from_depth_map(base: Grid, lmax: int, D: np.ndarray,
                       graded: bool = False) -> "CompositeGrid":
        """Leaves from a target depth per finest cell (values in
        [base.level, lmax], at the lmax resolution), graded 2:1 unless
        ``graded`` says it already is."""
        lmin = base.level
        D = np.asarray(D, np.int32)
        if not graded:
            D = grade_depth_map(D)
        Ms = {l: _pool_reduce_np(D, 1 << (lmax - l), base.dim, np.max)
              for l in range(lmax, lmin - 1, -1)}
        masks = {}
        for l in range(lmin, lmax + 1):
            leaf = Ms[l] <= l
            if l > lmin:
                leaf &= _repeat_np(Ms[l - 1] > l - 1, 2, base.dim)
            masks[l] = leaf
        return CompositeGrid.build(base, masks)

    @staticmethod
    def from_refine_fn(base: Grid, lmax: int,
                       refine: Callable) -> "CompositeGrid":
        """Leaves from an indicator: a level-l cell (l < lmax) is refined
        where ``refine(x, y[, z], l)`` (numpy cell centres) is True."""
        lmin = base.level
        gf = dataclasses.replace(base, level=lmax)
        D = np.full(gf.shape, lmin, np.int32)
        for l in range(lmin, lmax):
            g = dataclasses.replace(base, level=l)
            want = np.asarray(refine(*(np.asarray(c) for c in g.centers), l),
                              bool)
            D = np.maximum(D, np.where(_repeat_np(want, 1 << (lmax - l),
                                                  base.dim), l + 1, lmin))
        return CompositeGrid.from_depth_map(base, lmax, D)

    @property
    def topo(self) -> Topo:
        return Topo(base=self.base, lmin=self.lmin, lmax=self.lmax)

    def grid(self, l: int) -> Grid:
        return dataclasses.replace(self.base, level=l)

    def leaf_np(self, l: int) -> np.ndarray:
        shape, buf, _ = self._masks[l - self.lmin]
        return np.frombuffer(buf, bool).reshape(shape)

    def active_np(self, l: int) -> np.ndarray:
        shape, _, buf = self._masks[l - self.lmin]
        return np.frombuffer(buf, bool).reshape(shape)

    def leaf_arrays(self, device=None) -> Dict[int, torch.Tensor]:
        """The leaf masks as bool tensors on ``device`` (the card by
        default), every level in one host-to-device copy."""
        return upload({l: self.leaf_np(l)
                       for l in range(self.lmin, self.lmax + 1)},
                      default_device(device))

    def n_leaves(self) -> int:
        return int(sum(int(np.frombuffer(b, bool).sum())
                       for _, b, _ in self._masks))

    def depth_map(self) -> np.ndarray:
        """The leaf level of every finest cell."""
        gf = dataclasses.replace(self.base, level=self.lmax)
        D = np.full(gf.shape, self.lmin, np.int32)
        for l in range(self.lmin, self.lmax + 1):
            D = np.where(_repeat_np(self.leaf_np(l), 1 << (self.lmax - l),
                                    self.base.dim), l, D)
        return D


def grade_depth_map(D: np.ndarray) -> np.ndarray:
    """2:1 grading fixpoint: a cell's depth is at least any (8/26-)
    neighbour's less one (gfs_domain_reshape's corner loop,
    src/adaptive.c:1003-1009)."""
    D = np.asarray(D, np.int32)
    while True:
        Dn = np.maximum(D, _dilate_max(D) - 1)
        if np.array_equal(Dn, D):
            return D
        D = Dn


def _dilate_max(D: np.ndarray) -> np.ndarray:
    p = np.pad(D, 1, mode="edge")
    out = None
    for off in itertools.product((0, 1, 2), repeat=D.ndim):
        v = p[tuple(slice(o, o + D.shape[a]) for a, o in enumerate(off))]
        out = v if out is None else np.maximum(out, v)
    return out


def _pool_any_np(m: np.ndarray, dim: int) -> np.ndarray:
    return _pool_reduce_np(m, 2, dim, np.any)


def _pool_reduce_np(c: np.ndarray, rep: int, dim: int, op) -> np.ndarray:
    if rep == 1:
        return c
    sh = []
    for a in range(dim):
        sh += [c.shape[a] // rep, rep]
    return op(c.reshape(sh), axis=tuple(2 * a + 1 for a in range(dim)))


def _repeat_np(m: np.ndarray, rep: int, dim: int) -> np.ndarray:
    for a in range(dim):
        m = m.repeat(rep, axis=a)
    return m


def _device_of(u: dict):
    return next(iter(u.values())).device


def sync(u: dict, cg: CompositeGrid, fbc: bcs.FieldBC,
         homogeneous: bool = False, t: float = 0.0) -> dict:
    return amr.sync(u, cg.topo, cg.leaf_arrays(_device_of(u)), fbc,
                    homogeneous=homogeneous, t=t)


def composite_solve(rhs: dict, cg: CompositeGrid, fbc: bcs.FieldBC,
                    params: poisson.MultilevelParams = None, u0: dict = None,
                    t: float = 0.0, alpha=None, dia=None):
    """The host-looped composite solve of the tools and tests (reference
    composite.py:201-233): cycles until max|leaf residual| <= tolerance
    (absolute), at least nitermin and at most nitermax.  Returns (u, the
    max leaf residual after each cycle)."""
    params = params or poisson.MultilevelParams()
    topo, leaf = cg.topo, cg.leaf_arrays(_device_of(rhs))
    u = {l: torch.zeros_like(rhs[l]) for l in topo.levels} if u0 is None \
        else dict(u0)
    if not amr._dirichlet(fbc) and dia is None:
        mean = amr.leaf_volume_mean(rhs, topo, leaf)
        rhs = {l: rhs[l] - mean for l in rhs}
    hist = []
    for it in range(params.nitermax):
        u = amr.cycle(u, rhs, topo, leaf, fbc, params, alpha=alpha, dia=dia,
                      t=t)
        res = amr.leaf_residual(u, rhs, topo, leaf, fbc, alpha=alpha,
                                dia=dia, t=t)
        rinf = max(float(res[l].abs().max()) for l in res)
        hist.append(rinf)
        if it + 1 >= params.nitermin and rinf <= params.tolerance:
            break
    return u, hist


def flatten(u: dict, cg: CompositeGrid, fbc: bcs.FieldBC) -> torch.Tensor:
    """The finest level of the synced field."""
    return amr.flatten(u, cg.topo, cg.leaf_arrays(_device_of(u)), fbc)
