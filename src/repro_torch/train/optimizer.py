"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule.

Port of ``repro.train.optimizer``.  Parameters, gradients and moments are
dicts of tensors keyed by the model's ``state_dict`` names.  Moments are
kept in ``moment_dtype`` (f32 by default, whatever the parameters' type);
each leaf is updated in f32 and cast back to its own type, in place (the
reference returns new arrays; at full width a second copy of the weights
and moments would not fit beside them).

Which parameters decay follows the reference's layout, not the port's: the
reference decays every leaf of two or more dimensions (``p.ndim >= 2``) of
its pytree, in which the layers inside the whole repetitions of the
config's ``block_pattern`` are stacked on a leading axis, so each of their
tensors, norms included, has two or more.  The port keeps every layer apart
(``models.convert``); ``decay_flags`` gives each of its tensors the
reference's flag.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # f32 by default; bf16 halves the moments' memory
    moment_dtype: str = "float32"


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), f32: linear warmup
    to ``peak_lr``, then a cosine down to ``min_lr_ratio * peak_lr`` at
    ``total_steps``."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: dict[str, torch.Tensor], cfg: OptimizerConfig | None = None) -> dict:
    """Zero moments beside each parameter, and the step count (int32)."""
    mdt = _MOMENT_DTYPES[(cfg or OptimizerConfig()).moment_dtype]
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=mdt, device=p.device) for n, p in params.items()}

    return {"mu": zeros(), "nu": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def decay_flags(cfg: ModelConfig, params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """Whether each parameter decays, as in the reference's layout: a
    tensor of a layer inside the stacked repetitions (layer index below
    ``(num_layers // len(block_pattern)) * len(block_pattern)``) always; a
    tail layer's, or a top-level one (``embed``, ``lm_head``,
    ``frontend_proj``, ``final_norm``), where its own ``ndim >= 2``."""
    stacked = (cfg.num_layers // len(cfg.block_pattern)) * len(cfg.block_pattern)
    flags = {}
    for name, p in params.items():
        parts = name.split(".")
        flags[name] = (parts[0] == "layers" and int(parts[1]) < stacked) or p.dim() >= 2
    return flags


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves = [torch.sum(torch.square(a.float())) for a in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], opt_state: dict,
                  cfg: OptimizerConfig, decay: dict[str, bool]):
    """One AdamW step over ``params`` in place, leaf by leaf in f32, with
    ``decay`` from ``decay_flags``, under a profiler range of its name
    (``train.optimizer``).  Returns (params, new_opt_state, metrics
    {"grad_norm", "lr"}); the moments are updated in place too."""
    with torch.profiler.record_function("train.optimizer"):
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = schedule(cfg, step)
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        for name, p in params.items():
            g = grads[name].float() * scale
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            mu.copy_(cfg.b1 * mu.float() + (1 - cfg.b1) * g)
            nu.copy_(cfg.b2 * nu.float() + (1 - cfg.b2) * g * g)
            u = (mu.float() / b1c) / (torch.sqrt(nu.float() / b2c) + cfg.eps)
            if decay[name]:
                u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        new_opt = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
        return params, new_opt, {"grad_norm": gnorm, "lr": lr}
