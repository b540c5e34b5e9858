"""Device policy of the port: the card by default, the CPU only on request.

Every public entry point takes ``device=None``.  ``None`` means CUDA and
raises when no card is present; only an explicit ``device="cpu"`` runs on
the CPU.  Nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on (see module docstring)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
