"""The port's training loss and its gradients against the reference's, on
the CPU, at ``reduced()`` sizes and T 64.

The reference draws its weights (``repro.models.init_params``) and
``params_from_jax`` carries them across; its gradients go through the same
function, so every leaf is compared under the port's name.  The batch is
``SyntheticLMData``'s (the two packages' data modules give it bit for bit),
or numpy draws from a seed for the frontends' inputs.  Tolerances, float32:
the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
max |g| (the same arithmetic summed in other orders).  bf16: 2e-2, or twice
the reference's own bf16 distance from its float32 run with the same
weights, whichever is larger (``test_torch_models._bf16_tol``'s rule), of
the loss and of each leaf."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro.train import make_loss_fn as ref_make_loss_fn
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.train import init_train_state, make_loss_fn

B, T = 2, 64
LOSS_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2


def pair(name: str, dtype: str = "float32", **changes):
    """(reference cfg, reference params, port cfg, port model with the
    reference's weights and its train state's gradients on)."""
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **changes)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    model = load_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    init_train_state(model)
    return rcfg, params, cfg, model


def lm_batch(cfg, step: int = 0, batch: int = B, seq_len: int = T) -> dict[str, np.ndarray]:
    return SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
                                      seed=1)).batch(step)


def ref_value_and_grads(rcfg, params, batch: dict):
    """(loss, {"ce", "aux"}, gradients as the port's state_dict) of the
    reference's ``make_loss_fn``."""
    fn = jax.jit(jax.value_and_grad(ref_make_loss_fn(rcfg), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, params_from_jax(
        rcfg, jax.tree.map(lambda g: np.asarray(g, np.float32), grads))


def port_value_and_grads(cfg, model, batch: dict):
    params = dict(model.named_parameters())
    loss, metrics = make_loss_fn(cfg)(model, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check(cfg, model, rcfg, params, batch, loss_tol=LOSS_TOL, grad_tol=GRAD_TOL):
    """The port's loss and every gradient leaf against the reference's."""
    rloss, rmetrics, rgrads = ref_value_and_grads(rcfg, params, batch)
    loss, metrics, grads = port_value_and_grads(cfg, model, batch)
    assert abs(loss - rloss) <= loss_tol * abs(rloss), (loss, rloss)
    assert abs(metrics["ce"] - rmetrics["ce"]) <= loss_tol * abs(rmetrics["ce"])
    assert sorted(grads) == sorted(rgrads)
    for name, g in grads.items():
        tol = grad_tol[name] if isinstance(grad_tol, dict) else grad_tol
        assert g.dtype == model.get_parameter(name).dtype
        assert rel(g.float().numpy(), rgrads[name].float().numpy()) <= tol, name
    return loss, grads


@pytest.mark.parametrize("name,changes", [("llama3.2-3b", {}), ("llama3.2-3b", {"remat": True}),
                                          ("gemma2-9b", {})], ids=["llama", "llama-remat", "gemma2"])
def test_loss_and_gradients_match_reference(name, changes):
    """gemma2-9b: local windows (32) below T, attention and final softcaps,
    post-norms, scaled embeddings, tied head.  ``remat`` runs each layer
    under torch.utils.checkpoint (the reference's jax.checkpoint)."""
    rcfg, params, cfg, model = pair(name, **changes)
    check(cfg, model, rcfg, params, lm_batch(cfg))


def test_bf16_loss_and_gradients_match_reference():
    rcfg, params, cfg, model = pair("llama3.2-3b", "bfloat16")
    batch = lm_batch(cfg)
    r32 = dataclasses.replace(rcfg, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    exact_loss, _, exact = ref_value_and_grads(r32, p32, batch)
    own_loss, _, own = ref_value_and_grads(rcfg, params, batch)
    loss_tol = max(BF16_TOL, 2 * abs(own_loss - exact_loss) / abs(exact_loss))
    grad_tol = {n: max(BF16_TOL, 2 * rel(own[n].float().numpy(), exact[n].float().numpy())) for n in exact}
    check(cfg, model, rcfg, params, batch, loss_tol, grad_tol)
