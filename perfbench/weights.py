"""Weights drawn from the seed on the device, in a few large calls.

Every parameter of a configuration is a spec ``(name, shape, served dtype,
draw)`` (the reference module's ``param_specs``).  The specs lie end to end
in one flat sequence of standard normal numbers, drawn in chunks of
``CHUNK`` from ``torch.Generator``s on the device, one seeded from (seed,
chunk) per chunk, so that any leaf can be drawn again alone.  A leaf takes
its numbers times its std (``("normal", std)``) or through the normal CDF
onto [lo, hi) (``("uniform", lo, hi)``), rounded to its served dtype.  The
program is handed those values, and the reference the same values made
float32.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 28
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_MIX = 0x9E3779B97F4A7C15


def _chunk_seed(seed: int, c: int) -> int:
    return (seed * _MIX + c) % (1 << 63)


def _draw(kind: tuple, z: torch.Tensor) -> torch.Tensor:
    if kind[0] == "normal":
        return z * kind[1]
    if kind[0] == "uniform":
        lo, hi = kind[1], kind[2]
        return lo + (hi - lo) * torch.special.ndtr(z)
    raise ValueError(f"unknown draw {kind!r}")


def leaves(specs, seed: int, device, *, f32: bool = False, only=None):
    """Yield (name, tensor) for each spec in order (or those named in
    ``only``): the served values, or with ``f32`` those values made
    float32."""
    total = sum(math.prod(s[1]) for s in specs)
    dev = torch.device(device)
    cache: dict[int, torch.Tensor] = {}

    def chunk(c: int) -> torch.Tensor:
        if c not in cache:
            cache.clear()
            n = min(CHUNK, total - c * CHUNK)
            g = torch.Generator(device=dev).manual_seed(_chunk_seed(seed, c))
            cache[c] = torch.randn(n, generator=g, dtype=torch.float32, device=dev)
        return cache[c]

    off = 0
    for name, shape, dtype, kind in specs:
        n = math.prod(shape)
        if only is None or name in only:
            parts, a = [], off
            while a < off + n:
                c = a // CHUNK
                b = min(off + n, (c + 1) * CHUNK)
                parts.append(chunk(c)[a - c * CHUNK:b - c * CHUNK])
                a = b
            z = parts[0] if len(parts) == 1 else torch.cat(parts)
            t = _draw(kind, z).to(_DTYPES[dtype]).view(shape)
            yield name, (t.float() if f32 else t)
        off += n
    cache.clear()
