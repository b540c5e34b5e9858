"""Prefix sums in a fixed order of additions.

The reference adds its running sums with ``jnp.cumsum``, which XLA's CPU
backend folds in blocks of 16: sequentially within each block, then the
block totals the same way, recursively.  ``cumsum(a, 16)`` (``xla_cumsum``)
adds in that order, so every sum has the reference's bits; the fit-table
kernel (``csrc/rangemax.cu``) reproduces the same order on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

XLA_SCAN_BLOCK = 16


def cumsum(a: torch.Tensor, block: int) -> torch.Tensor:
    """Inclusive prefix sum along the last axis: sequential within blocks of
    ``block``, plus the block totals' own prefix sum (the same way,
    recursively).  ``block >= n`` is one sequential fold, the order of a
    scan; ``block = 16`` is the order of XLA's CPU ``cumsum``."""
    n = a.shape[-1]
    if n <= block:
        out = torch.empty_like(a)
        acc = torch.zeros_like(a[..., 0])
        for i in range(n):
            acc = torch.add(acc, a[..., i], out=out[..., i])
        return out
    m = -(-n // block)
    local = cumsum(F.pad(a, (0, m * block - n)).reshape(*a.shape[:-1], m, block), block)
    totals = cumsum(local[..., -1], block)
    local += exclusive(totals)[..., None]
    return local.reshape(*a.shape[:-1], m * block)[..., :n]


def exclusive(incl: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Shift an inclusive prefix along the last axis by one, ``fill`` first."""
    return torch.cat([torch.full_like(incl[..., :1], fill), incl[..., :-1]], dim=-1)


def xla_cumsum(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` in the order of XLA's CPU ``cumsum``."""
    return cumsum(a.movedim(dim, -1), XLA_SCAN_BLOCK).movedim(-1, dim)
