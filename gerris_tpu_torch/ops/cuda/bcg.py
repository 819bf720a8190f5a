"""The BCG advection kernels, and the route choice and BC encoding of the
BCG/projection kernels (counterpart of gerris_tpu/ops/pallas/bcg.py).

``kernel_spec`` encodes a FieldBC for the kernels as ghost = sgn *
mirror + off per side, sides ordered (x lo, x hi, y lo, y hi), or returns
None for BCs outside their scope (periodic rows, inhomogeneous Neumann).
``applicable`` says whether the kernel route applies at all.

K14 ``advect2d``, the corrector advection increment of one component,
and K7 ``advect2d_pair``, both components' increments in one launch (with
the ``rr_dia`` mode that also gives the first residual of their diffusion
systems), are one engine in ``gerris_tpu_torch/csrc/bcg.cu`` on haloed
shared-memory tiles (K14 its one-component instance); its source notes
give the arithmetic, the bound on the H100 and the design.  ``tile_plan``
gives the tile of that engine and of K6 (csrc/predict.cu).
The wrappers follow
ops/cuda/rbgs.py: CPU tensors take the plain version (the torch route,
which also serves the BCs the kernel refuses), CUDA tensors launch the
kernel (counted in ``LAUNCHES``) or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import bc as bcs
from ...solvers import advection as adv
from .rbgs import (_call, _on_cpu, check, check_faces, doubles, pointers,
                   residual_restrict_plain)

# kernel launches by wrapper name, counted only where a kernel launches
LAUNCHES = {"advect2d": 0, "advect2d_pair": 0}

# the rr_dia mode takes grids of whole tiles of K1's 32 x 8 blocks
# (columns, rows), as the TPU kernel's pools do
RR_TILE = (32, 8)
# the tiles (rows, columns) that K6's and the K7/K14 engine's kernels are
# built for.  The wrappers take the first: at 2048^2 float32 on the H100
# it gave K7 its lowest time, K6 and K14 theirs within 3% (PERF.md), and
# a small grid the most blocks
TILES = ((16, 32), (32, 32), (16, 64))


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_spec(fbc: bcs.FieldBC, with_face_bc: bool = False):
    """dict(sgn, off, per_y, fb_x, fb_y) for ``fbc``, or None when the BCs
    are outside the kernels' scope.  ``with_face_bc``: also give the
    Dirichlet value forced on each axis' domain-boundary faces (None for
    a non-Dirichlet side).  Callable values and the Navier and contact kinds
    are refused, as the reference refuses them (gerris_tpu/ops/pallas/
    bcg.py:423-425)."""
    if not bcs.kernel_ghosts(fbc) or bcs.has_kind(fbc, bcs.CONTACT):
        return None
    sgn = [1.0] * 4
    off = [0.0] * 4
    fb = [[None, None], [None, None]]
    per_y = False
    for ax in range(2):
        for side in range(2):
            b = fbc.sides[ax][side]
            k = 2 * ax + side
            if b.kind == bcs.PERIODIC:
                if ax == 0:
                    return None          # periodic rows: the torch route
                per_y = True
                continue
            if b.kind == bcs.DIRICHLET:
                sgn[k] = -1.0
                off[k] = 2.0 * b.value
                if with_face_bc:
                    fb[ax][side] = b.value
            elif b.value != 0.0:         # inhomogeneous Neumann
                return None
    return dict(sgn=tuple(sgn), off=tuple(off), per_y=per_y,
                fb_x=tuple(fb[0]) if with_face_bc else None,
                fb_y=tuple(fb[1]) if with_face_bc else None)


def applicable(grid, par=None) -> bool:
    """2D with the centred Godunov advection scheme (or no scheme).

    The reference also asks for the TPU backend, float32 and n >= 32/128.
    The port drops those tests on purpose: the kernel route and the torch
    route compute the same function, and the route depends on the
    configuration only, never on the device, the dtype or the size (the
    rule ROADMAP states for the multigrid schedule)."""
    if grid.dim != 2:
        return False
    return par is None or (par.gradient == "centered"
                           and par.scheme == "godunov")


def face_specs(u_bcs):
    """(spec_u, spec_v) of the two velocity components with face BCs when
    the face-building kernels (K6 predict_xy, K9 interp_faces) take them:
    Dirichlet x faces for u, Dirichlet or periodic y faces for v, and one
    periodicity for both (gerris_tpu/models/ns.py:190-196).  Else None."""
    su = kernel_spec(u_bcs[0], with_face_bc=True)
    sv = kernel_spec(u_bcs[1], with_face_bc=True)
    if (su is None or sv is None or su["per_y"] != sv["per_y"]
            or None in su["fb_x"]
            or not (sv["per_y"] or None not in sv["fb_y"])):
        return None
    return su, sv


def advect_spec(fbc: bcs.FieldBC):
    """kernel_spec(fbc, with_face_bc=True) where K14 takes ``fbc``, else
    None: periodic y is refused as well, since the kernel's gmac ghosts
    are edge values (gerris_tpu/models/ns.py:264, :345)."""
    spec = kernel_spec(fbc, with_face_bc=True)
    return None if spec is None or spec["per_y"] else spec


# -----------------------------------------------------------------------------
# Input checks and the tile plan shared by the wrappers
# -----------------------------------------------------------------------------

def tile_plan(tile=None):
    """(rows, columns) of the tile of a K6, K7 or K14 launch: TILES[0],
    or ``tile`` (one of TILES) for tests.  The tile changes the launch
    geometry only: the outputs are bit-identical for every tile (a
    divergence's total sums in another order)."""
    if tile is None:
        return TILES[0]
    tile = tuple(tile)
    if tile not in TILES:
        raise ValueError(f"tile {tile}: want one of {TILES}")
    return tile


def refused(name, what):
    return ValueError(f"{name}: {what} outside the kernel's scope; the "
                      "caller takes the plain version for such BCs")


# -----------------------------------------------------------------------------
# K14 advect2d and K7 advect2d_pair
# -----------------------------------------------------------------------------

def advect2d_plain(v, c, ufx, ufy, dt, grid, fbc, g=None, gp=None,
                   oscale=None, t=0.0):
    """The torch route: BCG face values of ``v`` on both axes with the
    advecting velocities from the MAC faces, the Godunov choice, the gmac
    face correction, the Dirichlet faces of axis ``c`` (none for a
    passive tracer, ``c`` None) and the flux difference (reference:
    src/timestep.c:976-1017; solvers/advection.advection_increment).
    Corner ghosts in the kernel's order where K14 takes ``fbc``, else the
    reference's generic route's (solvers/advection.advected_face_values).
    Callable BC values (which K14 does not take) are evaluated at time
    ``t``."""
    uf = [ufx, ufy]
    g_pad = None if g is None else \
        bcs.apply_bc(g, grid, bcs.grad_bc(fbc), 1, corners=False)
    fv = adv.advection_increment(
        v, uf, adv.mac_cell_mean(uf, grid), grid, fbc, dt, c=c, g_pad=g_pad,
        t=t, kernel_corners=advect_spec(fbc) is not None)
    if gp is not None:
        fv = fv - dt * gp
    return fv if oscale is None else oscale * (v + fv)


def advect2d_pair_plain(v0, v1, ufx, ufy, dt, grid, fbcs, g=None, gp=None,
                        oscale=None, rr_dia=None):
    """advect2d_plain of each component; with ``rr_dia``, each output then
    goes through residual_restrict_plain as the rhs of its diffusion
    system (L - rr_dia) u = rhs at u = v, with the system's ghosts (the
    kernel encoding of its BCs)."""
    g = g or (None, None)
    gp = gp or (None, None)
    outs = [advect2d_plain(v, c, ufx, ufy, dt, grid, fbcs[c], g[c], gp[c],
                           oscale) for c, v in enumerate((v0, v1))]
    if rr_dia is None:
        return outs
    rrs = []
    for c, (v, rhs) in enumerate(zip((v0, v1), outs)):
        spec = advect_spec(fbcs[c])
        if spec is None:
            raise refused("advect2d_pair_plain rr_dia", f"BCs {fbcs[c]}")
        rrs.append(residual_restrict_plain(
            v, rhs, rr_dia, h2=grid.h * grid.h, signs=spec["sgn"],
            offs=spec["off"]))
    return tuple(list(x) for x in zip(*rrs))


def _check_advect(vs, ufx, ufy, gs, gps):
    n0, n1 = vs[0].shape
    for k, v in enumerate(vs):
        check(v, f"v{k}", (n0, n1))
    check_faces(ufx, ufy, n0, n1)
    for ts, name in ((gs, "g"), (gps, "gp")):
        for k, t in enumerate(ts):
            if t is not None:
                check(t, f"{name}{k}", (n0, n1))


def _launch_args(name, vs, cs, fbcs):
    """The per-component BC arguments of a launch: the sgn and off
    encodings, each component's forced-face mask (bit 0 the low face of
    its own axis, bit 1 the high) and those faces' values."""
    specs = [advect_spec(f) for f in fbcs]
    for c, f, spec in zip(cs, fbcs, specs):
        if spec is None or c not in (0, 1, None):
            raise refused(name, f"component {c} with BCs {f}")
    # a passive tracer (c None) forces no face
    fbs = [(None, None) if c is None else spec["fb_x"] if c == 0
           else spec["fb_y"] for c, spec in zip(cs, specs)]
    return (doubles(*(x for s in specs for x in s["sgn"])),
            doubles(*(x for s in specs for x in s["off"])),
            [(fb[0] is not None) | (fb[1] is not None) << 1 for fb in fbs],
            doubles(*(0.0 if b is None else b for fb in fbs for b in fb)))


def advect2d(v, c, ufx, ufy, dt, grid, fbc, g=None, gp=None, oscale=None,
             tile=None):
    """The BCG advection increment fv of component ``c``'s cells ``v``
    with the MAC faces (ufx, ufy) and the BCs ``fbc``: with ``g`` (the
    gmac cell gradient) the faces' dt/2 face-mean correction, with ``gp``
    fv -= dt gp, and with ``oscale`` the output oscale (v + fv), the
    implicit-diffusion rhs, instead of fv.  ``c`` None: a passive
    tracer's increment, no face forced (gerris_tpu/models/ns.py:461-
    465).  ``tile``: the kernel's tile (tile_plan), for tests."""
    _check_advect([v], ufx, ufy, [g], [gp])
    if _on_cpu(v, ufx, ufy, g, gp):
        return advect2d_plain(v, c, ufx, ufy, dt, grid, fbc, g, gp, oscale)
    sgn, off, (mask,), fb = _launch_args("advect2d", [v], [c], [fbc])
    n0, n1 = v.shape
    tr, tc = tile_plan(tile)
    out = torch.empty_like(v)
    _call("advect2d", v.dtype, v.device, v.data_ptr(), ufx.data_ptr(),
          ufy.data_ptr(), None if g is None else g.data_ptr(),
          None if gp is None else gp.data_ptr(), n0, n1, float(dt),
          float(grid.h), sgn, off, c or 0, mask, fb, int(oscale is not None),
          0.0 if oscale is None else float(oscale), out.data_ptr(), tr, tc)
    LAUNCHES["advect2d"] += 1
    return out


def advect2d_pair(v0, v1, ufx, ufy, dt, grid, fbcs, g=None, gp=None,
                  oscale=None, rr_dia=None, tile=None):
    """advect2d of both velocity components (v0 along x, v1 along y, BCs
    ``fbcs``) in one launch; ``g`` and ``gp`` are pairs or None, the
    folds as in advect2d.  Returns [out0, out1].  ``rr_dia`` (with
    ``oscale``): returns ([r0_0, r0_1], [r1_0, r1_1], [r2_0, r2_1]), the
    residual of each component's diffusion system (L - rr_dia) u = out at
    u = v and its two 2x2 pools, as residual_restrict_pair gives them.
    ``tile``: the kernel's tile (tile_plan), for tests."""
    g = g or (None, None)
    gp = gp or (None, None)
    vs = [v0, v1]
    _check_advect(vs, ufx, ufy, g, gp)
    if rr_dia is not None and oscale is None:
        raise ValueError("advect2d_pair: rr_dia needs oscale (the rhs)")
    if _on_cpu(*vs, ufx, ufy, *g, *gp):
        return advect2d_pair_plain(v0, v1, ufx, ufy, dt, grid, fbcs, g, gp,
                                   oscale, rr_dia)
    sgn, off, masks, fb = _launch_args("advect2d_pair", vs, [0, 1], fbcs)
    n0, n1 = v0.shape
    if rr_dia is not None and (n0 % RR_TILE[1] or n1 % RR_TILE[0]):
        raise ValueError(f"advect2d_pair: rr_dia wants whole {RR_TILE[0]}"
                         f"x{RR_TILE[1]} tiles, got {n0}x{n1} cells")
    tr, tc = tile_plan(tile)
    outs = [torch.empty_like(v) for v in vs]
    r1s = r2s = [None, None]
    if rr_dia is not None:
        r1s = [v.new_empty((n0 // 2, n1 // 2)) for v in vs]
        r2s = [v.new_empty((n0 // 4, n1 // 4)) for v in vs]
    _call("advect2d_pair", v0.dtype, v0.device,
          pointers(vs, g, gp, outs, r1s, r2s), ufx.data_ptr(),
          ufy.data_ptr(), n0, n1, float(dt), float(grid.h), sgn, off,
          (ctypes.c_int * 2)(*masks), fb, int(oscale is not None),
          0.0 if oscale is None else float(oscale), int(rr_dia is not None),
          0.0 if rr_dia is None else float(rr_dia), float(grid.h * grid.h),
          tr, tc)
    LAUNCHES["advect2d_pair"] += 1
    return outs if rr_dia is None else (outs, r1s, r2s)
