"""Per-rank checkpoint files (port of gerris_tpu/parallel/checkpoint.py,
its single-device path).

The reference writes one simulation file per process and joins them
with gfsjoin (src/output.c:189-195, :1378-1404, tools/gfsjoin2.c).  The
file layout is the JAX package's: ``{prefix}-{rank}.npz`` with a
``__meta__`` holding each array's offset in the global array, which
tools/gfscombine.py reassembles.  One device writes one file at offset
0; a state sharded across devices, and a reload onto a mesh, wait for
the port's parallel/mesh.py (ROADMAP Queue 1, slice 9).
"""
from __future__ import annotations

import glob

import numpy as np
import torch

from ..core.device import default_device


def save_sharded(prefix: str, state: dict, meta: dict = None) -> list:
    """Write ``{prefix}-0.npz`` from the single-device arrays of ``state``
    (tensors or numpy, each in its own dtype); returns the file list."""
    arrays, offsets = {}, {}
    for name, arr in state.items():
        a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        arrays[name] = a
        offsets[name] = (0,) * a.ndim
    m = dict(meta or {})
    m["__offsets__"] = offsets
    m["__offset__"] = (0, 0)
    path = f"{prefix}-0.npz"
    np.savez(path, __meta__=np.asarray(m, dtype=object), **arrays)
    return [path]


def load_sharded(prefix: str, nranks: int = None, mesh=None, device=None,
                 dtype=None) -> dict:
    """Reassemble a checkpoint of one or more rank files (either
    package's) into {name: tensor on ``device``} (the CUDA card by
    default), each in its saved dtype unless ``dtype`` is given."""
    if mesh is not None:
        raise NotImplementedError("reloading onto a device mesh waits for "
                                  "parallel/mesh.py (ROADMAP slice 9)")
    device = default_device(device)
    files = sorted(glob.glob(f"{prefix}-*.npz"))
    if nranks is not None:
        files = files[:nranks]
    if not files:
        raise FileNotFoundError(f"{prefix}-*.npz")
    parts = []
    for p in files:
        with np.load(p, allow_pickle=True) as z:
            meta = z["__meta__"].item()
            parts.append((meta, {k: z[k] for k in z.files
                                 if not k.startswith("__")}))
    out = {}
    for name in parts[0][1]:
        offs = [tuple(m["__offsets__"][name]) for m, _ in parts]
        arrs = [f[name] for _, f in parts]
        nd = arrs[0].ndim
        shape = tuple(max(o[d] + a.shape[d] for o, a in zip(offs, arrs))
                      for d in range(nd))
        full = np.zeros(shape, arrs[0].dtype)
        for o, a in zip(offs, arrs):
            full[tuple(slice(o[d], o[d] + a.shape[d])
                       for d in range(nd))] = a
        t = torch.from_numpy(full)
        out[name] = t.to(device=device,
                         dtype=dtype or t.dtype).contiguous()
    return out
