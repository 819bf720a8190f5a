"""Haar wavelets on fields (port of gerris_tpu/spectral/wavelets.py).

Reference: modules/wavelets.c (OutputWavelet, GfsVariableWavelet,
Degraded, ErrorWavelet).  On a dense level the 2D multi-level Haar
transform's details are the reference's per-cell wavelet coefficients
(a cell less its parent's prolongation), and the detail energy per level
its compression-error criterion.
"""
from __future__ import annotations

import torch


def haar2d(f: torch.Tensor, levels: int):
    """The orthonormal 2D Haar decomposition over ``levels`` levels:
    (approx, details), details[k] = (LH, HL, HH) at level k (0 finest)."""
    details = []
    a = f
    for _ in range(levels):
        n0, n1 = a.shape
        b = a.reshape(n0 // 2, 2, n1 // 2, 2)
        p, q = b[:, 0, :, 0], b[:, 1, :, 0]
        r, s = b[:, 0, :, 1], b[:, 1, :, 1]
        details.append(((p - q + r - s) / 2, (p + q - r - s) / 2,
                        (p - q - r + s) / 2))
        a = (p + q + r + s) / 2
    return a, details


def ihaar2d(approx: torch.Tensor, details) -> torch.Tensor:
    """The inverse of haar2d."""
    a = approx
    for lh, hl, hh in reversed(details):
        n0, n1 = a.shape
        b = torch.empty((n0, 2, n1, 2), dtype=a.dtype, device=a.device)
        b[:, 0, :, 0] = (a + lh + hl + hh) / 2
        b[:, 1, :, 0] = (a - lh + hl - hh) / 2
        b[:, 0, :, 1] = (a + lh - hl - hh) / 2
        b[:, 1, :, 1] = (a - lh - hl + hh) / 2
        a = b.reshape(2 * n0, 2 * n1)
    return a


def wavelet_energy(f: torch.Tensor, levels: int) -> torch.Tensor:
    """The detail energy of each level (OutputWavelet)."""
    _, details = haar2d(f, levels)
    return torch.stack([sum(torch.sum(d * d) for d in trio)
                        for trio in details])


def degrade(f: torch.Tensor, levels: int) -> torch.Tensor:
    """GfsVariableDegraded: the finest ``levels`` detail bands zeroed."""
    a, details = haar2d(f, levels)
    return ihaar2d(a, [tuple(torch.zeros_like(d) for d in trio)
                       for trio in details])


def wavelet_error(f: torch.Tensor, levels: int) -> torch.Tensor:
    """GfsVariableErrorWavelet: the per-cell |f - degraded|."""
    return torch.abs(f - degrade(f, levels))
