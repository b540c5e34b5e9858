"""Training step: masked cross-entropy plus the MoE aux loss, microbatch
gradient accumulation, the AdamW update.

Port of ``repro.train.train_step``.  The train state is the reference's,
``{"params", "opt": {"mu", "nu", "step"}, "step"}``, with tensors keyed by
the model's ``state_dict`` names, so the checkpointer saves and restores it
as it is.  Its ``params`` are the model's own parameters (``requires_grad``
on): the step runs the model and updates them, and the moments, in place.

``cross_entropy`` takes the gold logit with ``gather``, not the reference's
one-hot contraction (which keeps vocab-sharded logits local on a mesh):
the value is the same, and at llama3.2-3b's training shape (B 2 x T 4,096
x V 128,256) an f32 one-hot would take 4.2 GB.

On the card every kernel of the model's path has a backward kernel, so
every config trains there: flash (``kernels.flash_bwd``), the MoE combine
(``kernels.moe_combine_bwd``; the MoE dispatch's gradient is a combine
launch, ``kernels.moe_dispatch.MoEDispatch``), the WKV recurrence
(``kernels.rwkv_wkv_bwd``) and the RG-LRU's (``kernels.rglru_scan_bwd``).
On the CPU autograd runs through the plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Transformer, forward_train
from repro_torch.train.optimizer import OptimizerConfig, apply_updates, decay_flags, init_opt_state

MOE_AUX_COEF = 0.01


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean masked cross-entropy of logits (..., V) against labels (...),
    under a profiler range of its name (``train.cross_entropy``)."""
    with torch.profiler.record_function("train.cross_entropy"):
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = (lse - gold) * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(cfg: ModelConfig):
    """``loss_fn(model, batch) -> (loss, {"ce", "aux"})``: ``batch`` holds
    ``labels`` and ``tokens`` (or ``features``), optionally ``mask``,
    ``patch_embeds`` and ``mrope_positions``."""

    def loss_fn(model: Transformer, batch: dict):
        logits, aux = forward_train(model, batch.get("tokens"), features=batch.get("features"),
                                    patch_embeds=batch.get("patch_embeds"),
                                    mrope_positions=batch.get("mrope_positions"))
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        mask = batch.get("mask")
        mask = (torch.ones(labels.shape, dtype=torch.float32, device=logits.device) if mask is None
                else torch.as_tensor(mask, device=logits.device).float())
        ce = cross_entropy(logits, labels, mask)
        return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}

    return loss_fn


def init_train_state(model: Transformer, opt_cfg: OptimizerConfig | None = None) -> dict:
    """The train state of ``model``, whose parameters it turns trainable:
    ``params`` its parameters by name, zero moments, step 0."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def _split_batch(batch: dict, accum: int) -> list[dict]:
    """(B, ...) -> ``accum`` microbatches of B / accum rows; M-RoPE's (3, B,
    T) rows split on dim 1."""
    parts = {}
    for name, a in batch.items():
        a = torch.as_tensor(a)
        parts[name] = a.chunk(accum, dim=1 if name == "mrope_positions" else 0)
    return [{name: chunks[i] for name, chunks in parts.items()} for i in range(accum)]


def make_train_step(cfg: ModelConfig, train_cfg: TrainConfig, model: Transformer):
    """``train_step(state, batch) -> (state, metrics)`` for
    ``init_train_state(model)``'s state: the gradient of the loss (summed in
    f32 over ``accum_steps`` microbatches and divided by their number), then
    AdamW.  Metrics: ``loss``, ``ce``, ``aux`` (0 under accumulation, as in
    the reference), ``grad_norm``, ``lr``, as tensors on the model's device."""
    loss_fn = make_loss_fn(cfg)
    accum = train_cfg.accum_steps
    decay = decay_flags(cfg, dict(model.named_parameters()))

    def grads_of(params: dict, batch: dict):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _split_batch(batch, accum):
                l, _, g = grads_of(params, mb)
                for n, gi in g.items():
                    grads[n] += gi.float()
                loss = loss + l
                del g
            for gi in grads.values():
                gi /= accum
            loss = loss / accum
            metrics = {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=model.device)}
        _, opt, opt_metrics = apply_updates(params, grads, state["opt"], train_cfg.optimizer, decay)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
