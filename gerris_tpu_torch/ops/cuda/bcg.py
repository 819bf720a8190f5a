"""The BCG advection kernel, and the route choice and BC encoding of the
BCG/projection kernels (counterpart of gerris_tpu/ops/pallas/bcg.py).

``kernel_spec`` encodes a FieldBC for the kernels as ghost = sgn *
mirror + off per side, sides ordered (x lo, x hi, y lo, y hi), or returns
None for BCs outside their scope (periodic rows, inhomogeneous Neumann).
``applicable`` says whether the kernel route applies at all.

K14 ``advect2d``, the corrector advection increment of one component, has
its kernel in ``gerris_tpu_torch/csrc/bcg.cu``, whose source note gives
the arithmetic, the bound on the H100 and the design.  Its wrapper follows
ops/cuda/rbgs.py: CPU tensors take the plain version (the torch route,
which also serves the BCs the kernel refuses), CUDA tensors launch the
kernel (counted in ``LAUNCHES``) or raise.  K7 ``advect2d_pair`` will live
here too.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import bc as bcs
from ...solvers import advection as adv
from ..stencils import face_average
from .rbgs import _call, _on_cpu

# kernel launches by wrapper name, counted only where a kernel launches
LAUNCHES = {"advect2d": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_spec(fbc: bcs.FieldBC, with_face_bc: bool = False):
    """dict(sgn, off, per_y, fb_x, fb_y) for ``fbc``, or None when the BCs
    are outside the kernels' scope.  ``with_face_bc``: also give the
    Dirichlet value forced on each axis' domain-boundary faces (None for
    a non-Dirichlet side).  The port's BCs hold constant values only, so
    the reference's callable-value refusal is the BC's own (core/bc.py)."""
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
# Input checks shared by the wrappers
# -----------------------------------------------------------------------------

def check(t, name, shape):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, want float32/float64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_faces(ufx, ufy, n0, n1):
    check(ufx, "ufx", (n0 + 1, n1))
    check(ufy, "ufy", (n0, n1 + 1))


def doubles(*vals):
    """A host array of C doubles (the kernels' BC values)."""
    return (ctypes.c_double * len(vals))(*map(float, vals))


def refused(name, what):
    return ValueError(f"{name}: {what} outside the kernel's scope; the "
                      "caller takes the plain version for such BCs")


# -----------------------------------------------------------------------------
# K14 advect2d
# -----------------------------------------------------------------------------

def advect2d_plain(v, c, ufx, ufy, dt, grid, fbc, g=None, gp=None,
                   oscale=None):
    """The torch route: BCG face values of ``v`` on both axes with the
    advecting velocities from the MAC faces, the Godunov choice, the gmac
    face correction, the Dirichlet faces of axis ``c`` and the flux
    difference (reference: src/timestep.c:976-1017)."""
    uf = [ufx, ufy]
    uc_pad = adv.mac_cell_mean(uf, grid)
    fvals = adv.advected_face_values(v, grid, fbc, dt, uc_pad)
    g_pad = None if g is None else \
        bcs.apply_bc(g, grid, bcs.grad_bc(fbc), 1, corners=False)
    v_faces = []
    for a in range(grid.dim):
        vface = adv.upwind_face_value(fvals[a][0], fvals[a][1], uf[a], a)
        if g_pad is not None:
            vface = vface - face_average(g_pad, grid, a) * dt / 2.0
        if a == c:
            vface = bcs.apply_face_bc(vface, grid, fbc, a)
        v_faces.append(vface)
    fv = adv.flux_divergence(v_faces, uf, grid, dt)
    if gp is not None:
        fv = fv - dt * gp
    return fv if oscale is None else oscale * (v + fv)


def advect2d(v, c, ufx, ufy, dt, grid, fbc, g=None, gp=None, oscale=None):
    """The BCG advection increment fv of component ``c``'s cells ``v``
    with the MAC faces (ufx, ufy) and the BCs ``fbc``: with ``g`` (the
    gmac cell gradient) the faces' dt/2 face-mean correction, with ``gp``
    fv -= dt gp, and with ``oscale`` the output oscale (v + fv), the
    implicit-diffusion rhs, instead of fv."""
    n0, n1 = v.shape
    check(v, "v", (n0, n1))
    check_faces(ufx, ufy, n0, n1)
    for t, name in ((g, "g"), (gp, "gp")):
        if t is not None:
            check(t, name, (n0, n1))
    if _on_cpu(v, ufx, ufy, g, gp):
        return advect2d_plain(v, c, ufx, ufy, dt, grid, fbc, g, gp, oscale)
    spec = advect_spec(fbc)
    if spec is None or c not in (0, 1):
        raise refused("advect2d", f"component {c} with BCs {fbc}")
    fb = spec["fb_x"] if c == 0 else spec["fb_y"]
    mask = (fb[0] is not None) | (fb[1] is not None) << 1
    out = torch.empty_like(v)
    _call("advect2d", v.dtype, v.device, v.data_ptr(), ufx.data_ptr(),
          ufy.data_ptr(), None if g is None else g.data_ptr(),
          None if gp is None else gp.data_ptr(), n0, n1, float(dt),
          float(grid.h), doubles(*spec["sgn"]), doubles(*spec["off"]), c,
          mask, doubles(*(0.0 if b is None else b for b in fb)),
          int(oscale is not None), 0.0 if oscale is None else float(oscale),
          out.data_ptr())
    LAUNCHES["advect2d"] += 1
    return out
