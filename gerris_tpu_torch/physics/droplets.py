"""Droplets: their labels, and their conversion to and from particles (port
of gerris_tpu/physics/droplets.py).

Reference: gfs_domain_tag_droplets (src/domain.c:3727), GfsDropletToParticle
(modules/particulatecommon.c:1278-1507), GfsParticleToDroplet (:1732-1904)
and GfsRemoveDroplets.  The labelling runs on the host with scipy's
connected components, as the reference designs it (these are host events
between steps): the fraction goes to the host once per call.  The
statistics and the conversions take and return tensors on the caller's
device.

droplets_to_particles returns the particles as one dict of stacked tensors
(pos, vel (k, dim); vol, mass (k,)), ready for particles.feed_particles,
where gerris_tpu returns a list of one dict per droplet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.grid import Grid, center_coords
from . import vof as vofm


def tag_droplets(f, threshold: float = 1e-4, periodic=(False, False)):
    """The connected regions of f > threshold (4-connectivity), merged
    across the periodic axes: (labels, an int numpy array with 0 for
    empty cells and 1..count, count).  On the host (gfs_domain_tag_droplets
    src/domain.c:3727)."""
    from scipy import ndimage

    fa = f.detach().cpu().numpy() if isinstance(f, torch.Tensor) \
        else np.asarray(f)
    lab, n = ndimage.label(fa > threshold)
    for ax, per in enumerate(periodic):
        if not per:
            continue
        lo = np.take(lab, 0, axis=ax)
        hi = np.take(lab, -1, axis=ax)
        for a, b in zip(lo.ravel(), hi.ravel()):
            if a > 0 and b > 0 and a != b:
                lab[lab == max(a, b)] = min(a, b)
    ids = np.unique(lab)
    ids = ids[ids > 0]
    remap = np.zeros(lab.max() + 1, dtype=np.int32)
    remap[ids] = np.arange(1, len(ids) + 1, dtype=np.int32)
    return remap[lab], len(ids)


def _sums(lab: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Per label 1..n, the sum of ``w`` over its cells."""
    out = torch.zeros(n + 1, dtype=w.dtype, device=w.device)
    return out.index_add_(0, lab, w.reshape(-1))[1:]


def droplet_stats(f: torch.Tensor, labels, n: int, grid: Grid, U=None):
    """Per droplet: cell count (a host numpy array, from the labels),
    volume, centroid (n, dim) and mean velocity (n, dim; zero without
    ``U``), tensors on f's device (compute_droplet_properties,
    particulatecommon.c:1278-1420)."""
    labels = np.asarray(labels)
    counts = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    lab = torch.as_tensor(labels.ravel(), dtype=torch.int64).to(f.device)
    w = f.reshape(-1)
    cv = grid.cell_volume
    vol = _sums(lab, w, n) * cv
    den = torch.clamp(vol, min=torch.finfo(vol.dtype).tiny)
    xs = center_coords(grid, f.device, f.dtype)
    cent = torch.stack([_sums(lab, w * x.reshape(-1), n) * cv / den
                        for x in xs], dim=1)
    if U is None:
        return counts, vol, cent, torch.zeros_like(cent)
    vel = torch.stack([_sums(lab, w * u.reshape(-1), n) * cv / den
                       for u in U], dim=1)
    return counts, vol, cent, vel


def droplets_to_particles(f: torch.Tensor, U, grid: Grid, min_cells: int,
                          rho_p: float = 1.0, largest_keep: int = 1):
    """The droplets of fewer than ``min_cells`` cells become particles and
    leave the fraction; the ``largest_keep`` largest droplets never do
    (the reference keeps the main body, particulatecommon.c:1430-1470).
    Returns (the new fraction, the particles {pos, vel, vol, mass}),
    stacked tensors on f's device (none: k = 0)."""
    labels, n = tag_droplets(f)
    dim = grid.dim
    if n == 0:
        z = f.new_zeros((0, dim))
        return f, {"pos": z, "vel": z.clone(), "vol": f.new_zeros(0),
                   "mass": f.new_zeros(0)}
    counts, vol, cent, vel = droplet_stats(f, labels, n, grid, U)
    order = np.argsort(-counts)
    keep = set(order[:largest_keep] + 1)
    conv = np.array([k for k in range(1, n + 1)
                     if k not in keep and counts[k - 1] < min_cells],
                    dtype=np.int64)
    flag = np.zeros(n + 1, dtype=bool)
    flag[conv] = True
    up = torch.as_tensor(np.concatenate([flag[labels.ravel()]
                                         .astype(np.int64), conv - 1]))
    up = up.to(f.device)
    gone = up[: labels.size].reshape(f.shape).bool()
    sel = up[labels.size:]
    v = vol[sel]
    return torch.where(gone, 0.0, f), {
        "pos": cent[sel], "vel": vel[sel], "vol": v, "mass": rho_p * v}


def particle_to_droplet(f: torch.Tensor, pos, vol, grid: Grid):
    """A particle stamped back into the fraction as a resolved disc
    (sphere) of its volume (GfsParticleToDroplet,
    particulatecommon.c:1732); ``pos`` (dim,) and ``vol`` tensors or
    numbers.  Nothing is read back to the host.

    The stamp is fraction_from_levelset's, which underestimates a small
    disc's area (its fractions are linear between the cell vertices), and
    gerris_tpu rescales every cell of it by vol / (its volume), so that
    a full cell exceeds 1 and the clamp to [0, 1] drops the excess: a
    droplet of radius 1-3 h loses 3-15% of its volume, and a disc that
    holds no cell vertex stamps nothing (ROADMAP Queue 3).  The port
    keeps the volume: where gerris_tpu's rescale leaves every cell within
    1 (or shrinks the stamp) it is the same; else the missing volume goes
    into the stamp's partial cells in proportion to their free room;
    and a disc with no vertex goes whole into the cell that holds the
    particle (at most a cell's volume)."""
    dt, dev = f.dtype, f.device
    pos = torch.as_tensor(pos, dtype=dt).to(dev)
    vol = torch.as_tensor(vol, dtype=dt).to(dev)
    if grid.dim == 2:
        R = torch.sqrt(vol / math.pi)
    else:
        R = torch.pow(3.0 * vol / (4.0 * math.pi), 1.0 / 3.0)

    def phi(*x):
        out = R * R
        for a in range(grid.dim):
            out = out - (x[a] - pos[a]) ** 2
        return out

    tiny = torch.finfo(dt).tiny
    cv = grid.cell_volume
    df = vofm.fraction_from_levelset(grid, phi, device=dev, dtype=dt)
    cur = torch.sum(df) * cv
    scale = vol / torch.clamp(cur, min=tiny)
    room = torch.where((df > 0.0) & (df < 1.0), 1.0 - df, 0.0)
    alpha = torch.clamp((vol - cur) / torch.clamp(room.sum() * cv, min=tiny),
                        max=1.0)
    fits = (df.max() * scale <= 1.0) | (cur >= vol)
    df = torch.where(fits, df * scale, df + alpha * room)
    cell = torch.zeros_like(df)
    idx = tuple(torch.floor((pos[a] - grid.origin[a]) / grid.h).long()
                .clamp(0, grid.shape[a] - 1).reshape(1)
                for a in range(grid.dim))
    cell.index_put_(idx, torch.clamp(vol / cv, max=1.0).reshape(1))
    df = torch.where(cur > 0.0, df, cell)
    return torch.clamp(f + df, 0.0, 1.0)


def remove_droplets(f: torch.Tensor, grid: Grid, min_cells: int,
                    largest_keep: int = 1) -> torch.Tensor:
    """GfsRemoveDroplets: the droplets below the size threshold deleted."""
    return droplets_to_particles(f, None, grid, min_cells,
                                 largest_keep=largest_keep)[0]
