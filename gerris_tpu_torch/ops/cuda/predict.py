"""The BCG predictor kernel: CUDA wrapper and its plain version.

Port of K6 ``predict_xy`` of gerris_tpu/ops/pallas/predict.py: both
velocity components' BCG predicted MAC faces (reference:
src/timestep.c:681-717, centred upwinding).  The kernel is in
``gerris_tpu_torch/csrc/predict.cu``, whose source note gives the
arithmetic, the bound on the H100 and the design.  The wrapper follows
ops/cuda/rbgs.py: CPU tensors take the plain version (the torch route,
which also serves the BCs the kernel refuses), CUDA tensors launch the
kernel (counted in ``LAUNCHES``) or raise.
"""
from __future__ import annotations

from ...core import bc as bcs
from ...solvers import advection as adv
from ..stencils import face_average
from .bcg import check, doubles, face_specs, refused
from .projops import div_buffers, divergence_plain
from .rbgs import _call, _on_cpu

# kernel launches by wrapper name, counted only where a kernel launches
LAUNCHES = {"predict_xy": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def predict_xy_plain(U, V, dt, grid, u_bcs, div_scale=None):
    """The torch route: per component, the BCG values along its own axis,
    the Godunov choice on the centred normal velocity and the Dirichlet
    boundary faces."""
    U = [U, V]
    uc_pad = [bcs.apply_bc(U[c], grid, u_bcs[c], 1, corners=False)
              for c in range(2)]
    uf = []
    for c in range(2):
        vp, vm = adv.advected_face_values(U[c], grid, u_bcs[c], dt, uc_pad,
                                          axes=(c,))[c]
        un = face_average(uc_pad[c], grid, c)
        uf.append(bcs.apply_face_bc(adv.upwind_face_value(vp, vm, un, c),
                                    grid, u_bcs[c], c))
    div = (None, None) if div_scale is None else \
        divergence_plain(uf[0], uf[1], div_scale)
    return (uf[0], uf[1]) + div


def predict_xy(U, V, dt, grid, u_bcs, div_scale=None):
    """(ufx (n0+1, n1), ufy (n0, n1+1), div, total): the BCG predicted MAC
    faces of both components at t + dt/2 from the centred U, V with their
    BCs ``u_bcs``.  ``div_scale``: div and total are the divergence of the
    faces built, (dx ufx + dy ufy) * div_scale, and its sum (the MAC
    projection's divergence folded in); else both are None."""
    n0, n1 = U.shape
    check(U, "U", (n0, n1))
    check(V, "V", (n0, n1))
    if _on_cpu(U, V):
        return predict_xy_plain(U, V, dt, grid, u_bcs, div_scale)
    specs = face_specs(u_bcs)
    if specs is None:
        raise refused("predict_xy", f"velocity BCs {u_bcs}")
    su, sv = specs
    fb_y = (0.0, 0.0) if su["per_y"] else sv["fb_y"]
    ufx, ufy = U.new_empty((n0 + 1, n1)), U.new_empty((n0, n1 + 1))
    divs = (None, None, None)
    if div_scale is not None:
        divs = div_buffers(U, n0, n1)
    _call("predict_xy", U.dtype, U.device, U.data_ptr(), V.data_ptr(), n0,
          n1, float(dt) / float(grid.h), doubles(*su["sgn"]),
          doubles(*su["off"]), doubles(*sv["sgn"]), doubles(*sv["off"]),
          int(su["per_y"]), doubles(*su["fb_x"], *fb_y),
          0.0 if div_scale is None else float(div_scale), ufx.data_ptr(),
          ufy.data_ptr(), *[None if t is None else t.data_ptr()
                            for t in divs])
    LAUNCHES["predict_xy"] += 1
    return ufx, ufy, divs[0], divs[2]
