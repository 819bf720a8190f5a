"""The projection kernels: CUDA wrappers and their plain versions.

Port of three TPU kernels of gerris_tpu/ops/pallas/projops.py: K4
``divergence_mac``, K5 ``correct_project`` and K9 ``interp_faces``.  The
kernels are in ``gerris_tpu_torch/csrc/projops.cu``; each one's source
note says what it replaces, what bounds it on the H100 and what its
design does about it.

Each wrapper checks its inputs (dtype float32/float64, shapes,
contiguity) and then:
* for tensors on the CPU, returns its plain version below: the torch
  route, which the callers also take for BCs that the kernel refuses
  (ops/cuda/bcg.kernel_spec), and which chip_smoke.py runs on the card as
  the kernels' reference;
* for CUDA tensors, launches the kernel on the current stream and adds
  one to its count in ``LAUNCHES``, or raises.  There is no fallback.

Cells are (n0, n1), x faces (n0+1, n1), y faces (n0, n1+1).  A
divergence's global sum comes back as a one-element tensor on the device
of its inputs, so the compatibility mean needs no host sync.
"""
from __future__ import annotations

import torch

from ...core import bc as bcs
from ..stencils import face_average, face_gradient
from .bcg import (check, check_faces, doubles, face_specs, kernel_spec,
                  refused)
from .rbgs import _call, _on_cpu

# kernel launches by wrapper name, counted only where a kernel launches
LAUNCHES = {"divergence_mac": 0, "correct_project": 0, "interp_faces": 0}

BLOCK = (32, 8)      # the kernels' threads per block (x = columns, y = rows)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -----------------------------------------------------------------------------
# Plain versions (the torch route)
# -----------------------------------------------------------------------------

def divergence_plain(ufx, ufy, scale):
    """(div, total): div = (dx ufx + dy ufy) * scale and its sum as a
    one-element tensor."""
    div = ((ufx[1:] - ufx[:-1]) + (ufy[:, 1:] - ufy[:, :-1])) * scale
    return div, div.sum().reshape(1)


def divergence_mac_plain(ufx, ufy, dt, h):
    return divergence_plain(ufx, ufy, 1.0 / (dt * h))


def correct_project_plain(p, ufx, ufy, dt, grid, p_bc, cells=None):
    """Face gradients of p (reference: src/timestep.c:60-145), the faces
    corrected by -dt of them, the cell gradient as the mean of a cell's
    two face gradients, and the cells corrected by -dt of it."""
    p_pad = bcs.apply_bc(p, grid, p_bc, 1, corners=False)
    gfx, gfy = (face_gradient(p_pad, grid, a) for a in range(2))
    gx = 0.5 * (gfx[:-1] + gfx[1:])
    gy = 0.5 * (gfy[:, :-1] + gfy[:, 1:])
    cells = (None, None) if cells is None else \
        (cells[0] - dt * gx, cells[1] - dt * gy)
    return (ufx - dt * gfx, ufy - dt * gfy, gx, gy) + cells


def interp_faces_plain(U, V, grid, u_bcs, gp=None, dtv=None,
                       div_scale=None):
    """Face means of the (gc re-added) cells with the Dirichlet boundary
    faces (reference: src/advection.c:546-566, src/simulation.c:520)."""
    if gp is not None:
        U, V = U + dtv * gp[0], V + dtv * gp[1]
    faces = []
    for c, u in enumerate((U, V)):
        pad = bcs.apply_bc(u, grid, u_bcs[c], 1, corners=False)
        faces.append(bcs.apply_face_bc(face_average(pad, grid, c), grid,
                                       u_bcs[c], c))
    div = (None, None) if div_scale is None else \
        divergence_plain(faces[0], faces[1], div_scale)
    return (faces[0], faces[1], U, V) + div


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------

def div_buffers(like, n0, n1, block=BLOCK):
    """(div, partials, total): the outputs and the block sums of a
    divergence pass over (n0, n1) cells with ``block`` threads per block,
    of the dtype and device of ``like``."""
    nblocks = -(-n1 // block[0]) * -(-n0 // block[1])
    return (like.new_empty((n0, n1)), like.new_empty(nblocks),
            like.new_empty(1))


def divergence_mac(ufx, ufy, dt, h, *, block=BLOCK):
    """(div, total): div = MAC divergence / dt, (dx ufx + dy ufy) / (h dt),
    and its global sum as a one-element tensor.  ``block`` (threads per
    block, a power-of-two count) changes the sum's association only: div
    is the same bit for bit."""
    n0, n1 = ufy.shape[0], ufx.shape[1]
    check_faces(ufx, ufy, n0, n1)
    if _on_cpu(ufx, ufy):
        return divergence_mac_plain(ufx, ufy, dt, h)
    div, partials, total = div_buffers(ufx, n0, n1, block)
    _call("divergence_mac", ufx.dtype, ufx.device, ufx.data_ptr(),
          ufy.data_ptr(), n0, n1, 1.0 / (dt * h), block[0], block[1],
          div.data_ptr(), partials.data_ptr(), total.data_ptr())
    LAUNCHES["divergence_mac"] += 1
    return div, total


def correct_project(p, ufx, ufy, dt, grid, p_bc, cells=None):
    """(ufx', ufy', gx, gy, U', V'): the post-solve correction of one
    projection.  Face gradients of p with its BCs ``p_bc``, uf -= dt
    grad_f p on every face (the domain faces included), the cell gradient
    as the mean of a cell's two face gradients, and with ``cells=(U, V)``
    the centred correction U -= dt gx, V -= dt gy (else U', V' are
    None)."""
    n0, n1 = p.shape
    check(p, "p", (n0, n1))
    check_faces(ufx, ufy, n0, n1)
    if cells is not None:
        for c, name in zip(cells, ("U", "V")):
            check(c, name, (n0, n1))
    if _on_cpu(p, ufx, ufy, *(cells or ())):
        return correct_project_plain(p, ufx, ufy, dt, grid, p_bc, cells)
    spec = kernel_spec(p_bc)
    if spec is None:
        raise refused("correct_project", f"pressure BCs {p_bc}")
    out = (torch.empty_like(ufx), torch.empty_like(ufy),
           torch.empty_like(p), torch.empty_like(p))
    out += (None, None) if cells is None else \
        (torch.empty_like(p), torch.empty_like(p))
    uc, vc = (None, None) if cells is None else \
        (cells[0].data_ptr(), cells[1].data_ptr())
    _call("correct_project", p.dtype, p.device, p.data_ptr(),
          ufx.data_ptr(), ufy.data_ptr(), uc, vc, n0, n1, float(dt),
          float(grid.h), doubles(*spec["sgn"]), doubles(*spec["off"]),
          int(spec["per_y"]),
          *[None if t is None else t.data_ptr() for t in out])
    LAUNCHES["correct_project"] += 1
    return out


def interp_faces(U, V, grid, u_bcs, gp=None, dtv=None, div_scale=None):
    """(ufx, ufy, U', V', div, total): face means of the cells with the
    Dirichlet values of ``u_bcs`` on x faces 0 and n0 and y faces 0 and n1
    (or periodic y faces).  ``gp=(Gx, Gy)`` with ``dtv``: the cells are
    first updated U' = U + dtv Gx, V' = V + dtv Gy (the gc re-add); else
    U', V' are U, V.  ``div_scale``: div and total are the divergence of
    the faces built, (dx ufx + dy ufy) * div_scale, and its sum; else
    both are None."""
    n0, n1 = U.shape
    check(U, "U", (n0, n1))
    check(V, "V", (n0, n1))
    if gp is not None:
        for g, name in zip(gp, ("Gx", "Gy")):
            check(g, name, (n0, n1))
    if _on_cpu(U, V, *(gp or ())):
        return interp_faces_plain(U, V, grid, u_bcs, gp, dtv, div_scale)
    specs = face_specs(u_bcs)
    if specs is None:
        raise refused("interp_faces", f"velocity BCs {u_bcs}")
    su, sv = specs
    fb_y = (0.0, 0.0) if su["per_y"] else sv["fb_y"]
    ufx, ufy = U.new_empty((n0 + 1, n1)), U.new_empty((n0, n1 + 1))
    cells = (U, V) if gp is None else (torch.empty_like(U),
                                       torch.empty_like(V))
    divs = (None, None, None)
    if div_scale is not None:
        divs = div_buffers(U, n0, n1)
    ptr = [None if t is None else t.data_ptr() for t in divs]
    if gp is None:
        g, ptr = (None, None), [None, None] + ptr
    else:
        g = (gp[0].data_ptr(), gp[1].data_ptr())
        ptr = [cells[0].data_ptr(), cells[1].data_ptr()] + ptr
    _call("interp_faces", U.dtype, U.device, U.data_ptr(), V.data_ptr(),
          *g, 0.0 if dtv is None else float(dtv), n0, n1,
          int(su["per_y"]), doubles(*su["fb_x"], *fb_y),
          0.0 if div_scale is None else float(div_scale), ufx.data_ptr(),
          ufy.data_ptr(), *ptr)
    LAUNCHES["interp_faces"] += 1
    return (ufx, ufy) + cells + (divs[0], divs[2])
