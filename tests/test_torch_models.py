"""The port's language model against the reference's, on the CPU.

The reference draws its weights (``repro.models.init_params``) and
``repro_torch.models.convert.params_from_jax`` carries them across; the
same tokens, made with numpy from a seed, go through both.  Tolerances on
the logits, relative to max |logits|: 1e-4 in float32 (the same arithmetic
in another summation order), 2e-2 in bf16 (the reference's own bound for
prefill + decode against the full forward, ``tests/test_models.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.model import Transformer, decode_step, forward, init_cache, init_params

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, T = 2, 16


def _pair(name: str, dtype: str, **changes):
    """(reference cfg, reference params, port cfg, port model) with the
    reference's weights."""
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **changes)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, params, cfg, load_params(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _tokens(cfg, n: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _unstack(cfg, cache) -> list[dict]:
    """The reference's stacked cache as one dict per layer, in layer order."""
    plen = len(cfg.block_pattern)
    n_rep = cfg.num_layers // plen
    layers = [None] * cfg.num_layers
    for i in range(plen):
        for r in range(n_rep):
            layers[r * plen + i] = {n: np.asarray(a[r]) for n, a in cache["blocks"][str(i)].items()}
    for j, c in cache["tail"].items():
        layers[n_rep * plen + int(j)] = {n: np.asarray(a) for n, a in c.items()}
    return layers


CASES = [
    ("llama3.2-3b", "float32", {}),
    ("llama3.2-3b", "bfloat16", {}),
    ("gemma2-9b", "float32", {}),
    ("gemma2-9b", "bfloat16", {}),
]


@pytest.mark.parametrize("name,dtype,changes", CASES, ids=lambda x: str(x) if not isinstance(x, dict) else
                         ",".join(f"{k}={v}" for k, v in x.items()))
def test_forward_and_decode_match_reference(name, dtype, changes):
    rcfg, params, cfg, model = _pair(name, dtype, **changes)
    toks = _tokens(cfg, T + 1)
    want, _, _ = ref_forward(params, rcfg, jnp.asarray(toks))
    got, _ = forward(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (B, T + 1, cfg.vocab_size)
    assert _rel(want, got.numpy()) <= TOL[dtype]
    last, _ = forward(model, torch.from_numpy(toks), last_only=True)  # the head on one position
    assert _rel(got[:, -1].numpy(), last[:, 0].numpy()) <= 1e-6

    _, rcache, _ = ref_forward(params, rcfg, jnp.asarray(toks[:, :T]), want_cache=True, cache_len=T + 8)
    rdec, rcache = ref_decode_step(params, rcfg, rcache, jnp.asarray(toks[:, T:]), jnp.full((B,), T, jnp.int32))
    _, cache = forward(model, torch.from_numpy(toks[:, :T]), want_cache=True, cache_len=T + 8)
    dec, cache = decode_step(model, cache, torch.from_numpy(toks[:, T:]), torch.full((B,), T, dtype=torch.int32))
    assert _rel(rdec, dec.numpy()) <= TOL[dtype]
    assert _rel(want[:, T], dec[:, 0].numpy()) <= 2e-2  # the cache contract, as the reference states it
    ref_layers = _unstack(rcfg, rcache)
    assert len(cache) == len(ref_layers) == cfg.num_layers
    for c, r in zip(cache, ref_layers):
        assert np.array_equal(c["pos"].numpy(), r["pos"])
        for n in ("k", "v"):
            assert c[n].shape == r[n].shape and c[n].dtype == model.embed.dtype
            assert _rel(r[n], c[n].float().numpy()) <= TOL[dtype]


def test_local_cache_rolls_past_the_window():
    """gemma2's local layers keep a window of 32 slots (reduced): a 40-token
    prefill and two decode steps wrap it, as in the reference."""
    rcfg, params, cfg, model = _pair("gemma2-9b", "float32")
    toks = _tokens(cfg, 42)
    _, rcache, _ = ref_forward(params, rcfg, jnp.asarray(toks[:, :40]), want_cache=True, cache_len=48)
    _, cache = forward(model, torch.from_numpy(toks[:, :40]), want_cache=True, cache_len=48)
    for t in (40, 41):
        tok = toks[:, t : t + 1]
        rl, rcache = ref_decode_step(params, rcfg, rcache, jnp.asarray(tok), jnp.full((B,), t, jnp.int32))
        gl, cache = decode_step(model, cache, torch.from_numpy(tok), torch.full((B,), t, dtype=torch.int32))
        assert _rel(rl, gl.numpy()) <= TOL["float32"]
    ref_layers = _unstack(rcfg, rcache)
    assert [c["pos"].shape[1] for c in cache] == [32, 48, 32, 48]
    for c, r in zip(cache, ref_layers):
        assert np.array_equal(c["pos"].numpy(), r["pos"])


def test_params_from_jax_covers_every_parameter():
    rcfg, params, cfg, _ = _pair("gemma2-9b", "bfloat16", num_layers=5)
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    names = dict(Transformer(cfg, seed=None, device="cpu").named_parameters())
    assert sorted(sd) == sorted(names)
    for n, t in sd.items():
        assert t.shape == names[n].shape and t.dtype == names[n].dtype, n
    ref_leaves = jax.tree.leaves(params)
    assert sum(t.numel() for t in sd.values()) == sum(int(np.prod(a.shape)) for a in ref_leaves)
    # bf16 travels bit for bit; repetition 1 of slot 1 is layer 3, the tail
    # (the layer past the last whole repetition) layer 4
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16)
    ref_bits = lambda a: np.asarray(a).view(np.uint16)
    assert np.array_equal(bits(sd["layers.3.attn.wq"]), ref_bits(params["blocks"]["1"]["attn"]["wq"][1]))
    assert np.array_equal(bits(sd["layers.4.mlp.wo"]), ref_bits(params["tail"]["0"]["mlp"]["wo"]))
    tail_norm = np.asarray(params["tail"]["0"]["ln1_post"]["scale"])
    assert np.array_equal(sd["layers.4.ln1_post.scale"].numpy(), tail_norm)


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma2-9b", "mistral-large-123b", "deepseek-67b"])
def test_param_count_matches_the_port(name):
    """At full size, on the meta device: the port's parameters are the
    reference's pytree, leaf for leaf in count; ``param_count()`` is exact
    for models without post-norms and, as the reference's own test allows,
    within 2% for gemma2 (its analytic count leaves the post-norms out)."""
    cfg = get_config(name)
    model = Transformer(cfg, seed=None, device="meta")
    n = sum(p.numel() for p in model.parameters())
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jax.eval_shape(
        lambda: ref_init_params(jax.random.PRNGKey(0), ref_config(name)))))
    assert n == ref
    if cfg.use_post_norm:
        assert n - cfg.param_count() == 2 * cfg.d_model * cfg.num_layers
        assert abs(n - cfg.param_count()) / n < 0.02
    else:
        assert n == cfg.param_count()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_unported_kinds_raise(name):
    cfg = get_config(name).reduced()
    kinds = set(cfg.layer_kinds)
    if cfg.frontend is not None or kinds & {"moe", "rwkv", "rglru"}:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
            init_params(cfg, device="cpu")
    else:
        assert len(init_params(cfg, device="cpu").layers) == cfg.num_layers


def test_init_params_is_seeded():
    cfg = get_config("llama3.2-3b").reduced()
    a, b, c = (init_params(cfg, seed=s, device="cpu") for s in (0, 0, 1))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.layers[0].attn.wq, c.layers[0].attn.wq)
    assert torch.equal(a.layers[0].ln1.scale, torch.zeros(cfg.d_model))  # the (1 + scale) form
    cache = init_cache(cfg, 2, 9, device="cpu")
    assert len(cache) == cfg.num_layers and all(torch.equal(c["pos"], torch.full((2, 9), -1, dtype=torch.int32))
                                                for c in cache)
    rc = _unstack(cfg, jax.tree.map(np.asarray, ref_init_cache(ref_config("llama3.2-3b").reduced(), 2, 9)))
    assert [tuple(c["k"].shape) for c in cache] == [r["k"].shape for r in rc]
