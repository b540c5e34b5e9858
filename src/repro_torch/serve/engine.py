"""Serving steps: prefill (build the cache) and decode (one token against it).

Port of ``repro.serve.engine``.  The steps take the model (a
``models.model.Transformer``) where the reference takes its parameter
pytree, and run under ``torch.inference_mode()``.  Their inputs are dicts
by name, as the reference's, so the modality frontends' inputs (audio
``features``, ``patch_embeds``, ``mrope_positions``) pass through them;
``greedy_generate`` is token-only, as the reference's.  The prefill step
applies the head to the last position only, since it returns only ``logits[:, -1]``
(the reference computes all T positions and slices).  The decode step
updates the cache in place and returns it.  ``cache_shape`` (a
``jax.eval_shape``) is not ported.

Also the admission-engine registry (``make_admission_controller``), the
one place that maps an engine name to a controller, shared by
``serve.stream``: ``"scalar"``, ``"batched"``, ``"sharded"`` and
``"sharded-scalar"``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Transformer, decode_step, forward
from repro_torch.serve.admission import (
    AdmissionController,
    BatchedAdmissionController,
    ShardedAdmissionController,
    ShardedScalarController,
)

# engine name -> controller class; "scalar" is the policy oracle, "batched"
# the single-card engine, "sharded" the carried-timeline control plane,
# "sharded-scalar" its per-shard scalar oracle
ADMISSION_ENGINES = ("scalar", "batched", "sharded", "sharded-scalar")


def make_admission_controller(
    engine: str,
    *,
    hbm_budget_mib: float,
    k: int = 4,
    interval_s: float = 0.5,
    n_shards: int = 4,
    device=None,
):
    """Build an admission controller by engine name.

    The single-host engines ignore ``n_shards``; ``"sharded"`` and
    ``"sharded-scalar"`` split the budget ``n_shards`` ways with crc32
    request placement (``serve.admission.shard_of``).  ``device`` is the
    device engines' (``"batched"``, ``"sharded"``; ``None``: the CUDA card);
    the host engines ignore it."""
    if engine == "scalar":
        return AdmissionController(hbm_budget_mib, k=k, interval_s=interval_s)
    if engine == "batched":
        return BatchedAdmissionController(hbm_budget_mib, k=k, interval_s=interval_s, device=device)
    if engine == "sharded-scalar":
        return ShardedScalarController(hbm_budget_mib, k=k, interval_s=interval_s, n_shards=n_shards)
    if engine == "sharded":
        return ShardedAdmissionController(hbm_budget_mib, k=k, interval_s=interval_s, n_shards=n_shards,
                                          device=device)
    raise ValueError(f"unknown admission engine {engine!r} (one of {ADMISSION_ENGINES})")


def _on(model: Transformer, dev: torch.device) -> None:
    if model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, the step runs on {dev}")


def make_prefill_step(cfg: ModelConfig, cache_len: int, device=None):
    """(model, inputs) -> (last-position logits (B, V) f32, cache sized
    ``cache_len``, or None for an encoder).  ``inputs`` holds what the
    architecture takes, by name: ``tokens`` (B, T), or ``features`` (B, T,
    frontend_dim) for audio frames; ``patch_embeds`` (B, P, D) and
    ``mrope_positions`` (3, B, T) for a vision model.  ``device=None`` is
    the CUDA card."""
    dev = resolve_device(device)

    def prefill(model: Transformer, inputs: dict):
        _on(model, dev)
        logits, cache = forward(model, inputs.get("tokens"), features=inputs.get("features"),
                                patch_embeds=inputs.get("patch_embeds"), mrope_positions=inputs.get("mrope_positions"),
                                want_cache=cfg.has_decode, cache_len=cache_len, last_only=True)
        return logits[:, -1], cache

    return prefill


def make_decode_step(cfg: ModelConfig, device=None):
    """(model, cache, {"tokens": (B, 1), "positions": (B,)}, and a vision
    model's "mrope_positions" (3, B, 1)) -> (logits (B, V), cache updated in
    place).  ``device=None`` is the CUDA card."""
    dev = resolve_device(device)

    def step(model: Transformer, cache: list, inputs: dict):
        _on(model, dev)
        logits, cache = decode_step(model, cache, inputs["tokens"], inputs["positions"],
                                    mrope_positions=inputs.get("mrope_positions"))
        return logits[:, 0], cache

    return step


def greedy_generate(model: Transformer, cfg: ModelConfig, tokens, steps: int, cache_len: int | None = None,
                    device=None) -> torch.Tensor:
    """Prefill + greedy decode: tokens (B, T) -> (B, steps) int32."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    B, T = tokens.shape
    cache_len = cache_len or (T + steps)
    prefill = make_prefill_step(cfg, cache_len, device=dev)
    step = make_decode_step(cfg, device=dev)
    logits, cache = prefill(model, {"tokens": tokens})
    out = [torch.argmax(logits, dim=-1).to(torch.int32)]
    for i in range(steps - 1):
        pos = torch.full((B,), T + i, dtype=torch.int32, device=dev)
        logits, cache = step(model, cache, {"tokens": out[-1][:, None], "positions": pos})
        out.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.stack(out, dim=1)
