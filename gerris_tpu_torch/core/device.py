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
