"""The device of the port's entry points: the CUDA card unless the caller
names another."""
from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card.  Without a
    card this raises: the entry points never fall back to the CPU on their
    own (pass device="cpu" for the plain versions on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def upload(arrays: dict, device) -> dict:
    """Host numpy arrays {key: array} -> tensors on ``device`` in ONE
    host-to-device copy: the arrays packed into one byte buffer (each
    at an 8-byte boundary), copied, and viewed back with their dtypes and
    shapes.  An adaptation's masks and tables take one such copy each."""
    import numpy as np
    device = torch.device(device)
    spans, off = {}, 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        spans[k] = (off, a)
        off += -(-a.nbytes // 8) * 8
    buf = np.zeros(max(off, 8), np.uint8)
    for off, a in spans.values():
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    out = {}
    for k, (off, a) in spans.items():
        t = torch.from_numpy(np.empty(0, a.dtype)).dtype
        out[k] = dev[off:off + a.nbytes].view(t).reshape(a.shape)
    return out
