"""The port's training loss and gradients against the reference's for the
modality frontends (hubert-xlarge's audio frames, non-causal;
qwen2-vl-72b's patch embeddings and M-RoPE rows), and the MoE loss, on the
CPU at ``reduced()`` sizes.  Tolerances as ``test_torch_train_grads``;
the MoE loss's ce, aux and total within 1e-5 relative and every gradient
leaf within 1e-4 of its max |g|, at capacity factor 8.0 (the reference's
MoE tests') and at the configs' 1.25."""

import numpy as np
import pytest

from test_torch_cuda import grid_positions
from test_torch_train_grads import B, T, check, lm_batch, pair, port_value_and_grads, ref_value_and_grads


def _bf16_normal(shape, seed: int) -> np.ndarray:
    """N(0, 1) draws rounded to bf16, held as float32: both packages cast
    them to the compute type."""
    import torch

    x = np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _labels(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("name", ["hubert-xlarge", "qwen2-vl-72b"])
def test_frontend_loss_and_gradients_match_reference(name):
    rcfg, params, cfg, model = pair(name)
    if cfg.frontend == "audio_frames":
        batch = {"features": _bf16_normal((B, T, cfg.frontend_dim), 3), "labels": _labels(cfg, 4)}
    else:
        batch = dict(lm_batch(cfg), patch_embeds=_bf16_normal((B, cfg.num_patches, cfg.d_model), 2),
                     mrope_positions=grid_positions(B, T, 2, 4))
    _, grads = check(cfg, model, rcfg, params, batch)
    if cfg.frontend == "audio_frames":  # the token embedding is held but unused
        assert not grads["embed"].any() and grads["frontend_proj"].any()


@pytest.mark.parametrize("capacity", [8.0, 1.25])
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_moe_loss_matches_reference(name, capacity):
    """The loss, ce and aux, and every gradient leaf (the router's and the
    experts' included), at the reference MoE tests' 8.0 and at the
    configs' 1.25."""
    rcfg, params, cfg, model = pair(name, capacity_factor=capacity)
    batch = lm_batch(cfg)
    rloss, rmetrics, _ = ref_value_and_grads(rcfg, params, batch)
    loss, metrics, _ = port_value_and_grads(cfg, model, batch)
    assert metrics["aux"] > 0
    for got, want in ((loss, rloss), (metrics["ce"], rmetrics["ce"]), (metrics["aux"], rmetrics["aux"])):
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert abs(loss - (metrics["ce"] + 0.01 * metrics["aux"])) <= 1e-6 * loss
    _, grads = check(cfg, model, rcfg, params, batch)
    assert all(grads[n].any() for n in grads if ".moe." in n)
