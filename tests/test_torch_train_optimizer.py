"""The port's AdamW against the reference's, on the CPU.

The reference's parameters (``repro.models.init_params``, float32) and
gradients (numpy draws from a seed, in its pytree) are carried across by
``params_from_jax``.  Tolerance rtol 1e-6: XLA fuses float32
multiply-adds where PyTorch rounds each operation.  bf16 moments are held
within one bf16 step (2^-8 relative): an f32 difference in the last place
can move a bf16 rounding.  That step moves the update of its parameter by
up to 2^-8 of |u| (|u| ~ 1 under Adam's normalisation), so with bf16
moments the parameters are held within lr * 2^-6 absolute beside rtol 1e-6
(three steps, a couple of flipped roundings each)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as opt

RTOL = 1e-6
BF16_RTOL = 2.0**-8


def _close(got: torch.Tensor, want, rtol: float, atol: float = 0.0) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30) + atol, np.abs(got - want).max()


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 150])
def test_schedule_matches_reference(step):
    cfg = opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    rcfg = ref_opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = ref_opt.schedule(rcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    _close(got, want, RTOL)


def _pair(name: str, seed: int, **changes):
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype="float32", **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", **changes)
    return rcfg, cfg, ref_init_params(jax.random.PRNGKey(seed), rcfg)


def _like(tree, rng, scale: float):
    return jax.tree.map(lambda a: (rng.normal(0, 1, a.shape) * scale).astype(np.float32), tree)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference_over_three_steps(moment_dtype):
    """Three AdamW steps on the same gradients, the second large enough to
    clip: params, mu, nu, grad_norm and lr after each step."""
    rcfg, cfg, rparams = _pair("llama3.2-3b", 0)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
    ocfg, rocfg = opt.OptimizerConfig(**kw), ref_opt.OptimizerConfig(**kw)
    params = {n: t.clone() for n, t in params_from_jax(cfg, jax.tree.map(np.asarray, rparams)).items()}
    state = opt.init_opt_state(params, ocfg)
    rstate = ref_opt.init_opt_state(rparams, rocfg)
    decay = opt.decay_flags(cfg, params)
    rng = np.random.default_rng(3)
    update = jax.jit(lambda p, g, s: ref_opt.apply_updates(p, g, s, rocfg))
    mtol = RTOL if moment_dtype == "float32" else BF16_RTOL
    patol = 0.0 if moment_dtype == "float32" else kw["peak_lr"] * 2.0**-6
    norms = []
    for scale in (1e-3, 1.0, 1e-2):
        grads = _like(rparams, rng, scale)
        rparams, rstate, rm = update(rparams, grads, rstate)
        _, state, m = opt.apply_updates(params, params_from_jax(cfg, grads), state, ocfg, decay)
        _close(m["grad_norm"], rm["grad_norm"], RTOL)
        _close(m["lr"], rm["lr"], RTOL)
        norms.append(float(m["grad_norm"]))
        assert int(state["step"]) == int(rstate["step"])
        for mine, theirs, tol, atol in ((params, rparams, RTOL, patol), (state["mu"], rstate["mu"], mtol, 0.0),
                                        (state["nu"], rstate["nu"], mtol, 0.0)):
            want = params_from_jax(cfg, jax.tree.map(np.asarray, theirs))
            for name, t in mine.items():
                _close(t, want[name].float().numpy(), tol, atol)
    assert all(t.dtype == torch.float32 for t in params.values())
    assert all(t.dtype == opt._MOMENT_DTYPES[moment_dtype] for t in state["mu"].values())
    assert max(norms) > ocfg.clip_norm > min(norms)  # one step clipped, one did not


def test_decay_follows_the_reference_layout():
    """gemma2-9b reduced to three layers: one repetition of its (local,
    global) pattern, stacked, and one tail layer.  With zero gradients only
    the decayed tensors move, so one step pins which decay: the stacked
    layers' norms move (the reference's stacked leaves have two dimensions),
    the tail layer's norms and the final norm do not, every matrix does."""
    rcfg, cfg, rparams = _pair("gemma2-9b", 1, num_layers=3)
    rparams = _like(rparams, np.random.default_rng(4), 1.0)  # nonzero norm scales
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    ocfg, rocfg = opt.OptimizerConfig(**kw), ref_opt.OptimizerConfig(**kw)
    params = {n: t.clone() for n, t in params_from_jax(cfg, jax.tree.map(np.asarray, rparams)).items()}
    before = {n: t.clone() for n, t in params.items()}
    zeros = jax.tree.map(np.zeros_like, rparams)
    rnew, _, _ = ref_opt.apply_updates(rparams, zeros, ref_opt.init_opt_state(rparams, rocfg), rocfg)
    opt.apply_updates(params, params_from_jax(cfg, zeros), opt.init_opt_state(params, ocfg), ocfg,
                      opt.decay_flags(cfg, params))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, rnew))
    for name, t in params.items():
        _close(t, want[name].numpy(), RTOL)
    moved = {n for n in params if not torch.equal(params[n], before[n])}
    assert {"layers.0.ln1.scale", "layers.1.ln2_post.scale", "layers.0.attn.wq", "layers.2.attn.wq",
            "embed"} <= moved
    assert not moved & {"layers.2.ln1.scale", "layers.2.ln1_post.scale", "layers.2.ln2.scale",
                        "layers.2.ln2_post.scale", "final_norm.scale"}
    assert moved == {n for n, d in opt.decay_flags(cfg, params).items() if d}
