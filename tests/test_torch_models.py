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
    ("qwen3-moe-235b-a22b", "float32", {}),
    ("grok-1-314b", "float32", {}),
    ("rwkv6-1.6b", "float32", {}),
    ("rwkv6-1.6b", "bfloat16", {}),
    ("rwkv6-1.6b", "float32", {"d_model": 128}),  # two heads
    ("recurrentgemma-2b", "float32", {}),
    ("recurrentgemma-2b", "bfloat16", {}),
    ("recurrentgemma-2b", "float32", {"num_layers": 8}),  # two tail rglru layers
]
RECURRENT = {"rwkv", "rglru"}
T_RECURRENT = 37  # as tests/test_models.py: the WKV chunk form pads 37 tokens to 64
STATE_NAMES = {"shift", "wkv", "cm_shift", "h", "conv"}


def _bf16_tol(rcfg, params, toks: np.ndarray) -> float:
    """bf16 tolerance of a recurrent model: 2e-2, or twice the reference's
    own bf16 rounding distance (its bf16 logits against its float32 ones
    with the same weights), whichever is larger.  Two bf16 runs that round
    in different places each lie about that distance from the float32
    function, so they may differ by twice it; the reduced rwkv's lies at
    2.2-3.6% of max |logits| (at 2e-2 the reference's own bf16 would fail)."""
    r32 = dataclasses.replace(rcfg, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, params)
    exact, _, _ = ref_forward(p32, r32, jnp.asarray(toks))
    own, _, _ = ref_forward(params, rcfg, jnp.asarray(toks))
    return max(TOL["bfloat16"], 2 * _rel(exact, own))
MOE_ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]
# At an MoE config's own capacity factor (1.25) a decode step (N = B tokens)
# and forward on T + 1 tokens drop different assignments, in the reference
# as in the port (ROADMAP Queue 3): the cache contract of an MoE model is
# checked at the factor the reference's own tests use for it, which is at
# least E / k for the reduced configs (E 4, k 2), so nothing is dropped.
CONTRACT_CAPACITY = 8.0


def _with_capacity(model: Transformer, factor: float) -> Transformer:
    """The same weights under ``capacity_factor = factor``."""
    cfg = dataclasses.replace(model.cfg, capacity_factor=factor)
    model.cfg = cfg
    for block in model.layers:
        block.cfg = cfg
    return model


@pytest.mark.parametrize("name,dtype,changes", CASES, ids=lambda x: str(x) if not isinstance(x, dict) else
                         ",".join(f"{k}={v}" for k, v in x.items()))
def test_forward_and_decode_match_reference(name, dtype, changes):
    rcfg, params, cfg, model = _pair(name, dtype, **changes)
    recurrent = bool(set(cfg.layer_kinds) & RECURRENT)
    T = T_RECURRENT if recurrent else globals()["T"]
    toks = _tokens(cfg, T + 1)
    tol = _bf16_tol(rcfg, params, toks) if recurrent and dtype == "bfloat16" else TOL[dtype]
    want, _, _ = ref_forward(params, rcfg, jnp.asarray(toks))
    got, _ = forward(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (B, T + 1, cfg.vocab_size)
    assert _rel(want, got.numpy()) <= tol
    last, _ = forward(model, torch.from_numpy(toks), last_only=True)  # the head on one position
    assert _rel(got[:, -1].numpy(), last[:, 0].numpy()) <= 1e-6

    _, rcache, _ = ref_forward(params, rcfg, jnp.asarray(toks[:, :T]), want_cache=True, cache_len=T + 8)
    rdec, rcache = ref_decode_step(params, rcfg, rcache, jnp.asarray(toks[:, T:]), jnp.full((B,), T, jnp.int32))
    _, cache = forward(model, torch.from_numpy(toks[:, :T]), want_cache=True, cache_len=T + 8)
    dec, cache = decode_step(model, cache, torch.from_numpy(toks[:, T:]), torch.full((B,), T, dtype=torch.int32))
    assert _rel(rdec, dec.numpy()) <= tol
    if recurrent:  # the cache contract on the port's own forward (bf16 rounds apart from the reference's)
        assert _rel(got[:, T].numpy(), dec[:, 0].numpy()) <= 2e-2
    elif cfg.num_experts:
        _with_capacity(model, CONTRACT_CAPACITY)
        full, _ = forward(model, torch.from_numpy(toks), last_only=True)
        _, c8 = forward(model, torch.from_numpy(toks[:, :T]), want_cache=True, cache_len=T + 8)
        dec8, _ = decode_step(model, c8, torch.from_numpy(toks[:, T:]), torch.full((B,), T, dtype=torch.int32))
        assert _rel(full[:, 0].numpy(), dec8[:, 0].numpy()) <= 2e-2
    else:
        assert _rel(want[:, T], dec[:, 0].numpy()) <= 2e-2  # the cache contract, as the reference states it
    ref_layers = _unstack(rcfg, rcache)
    assert len(cache) == len(ref_layers) == cfg.num_layers
    for c, r, kind in zip(cache, ref_layers, cfg.layer_kinds):
        assert sorted(c) == sorted(r)
        if kind in RECURRENT:
            assert set(c) <= STATE_NAMES
            for n in c:
                want_dtype = torch.float32 if n in ("wkv", "h") else model.embed.dtype
                assert c[n].shape == r[n].shape and c[n].dtype == want_dtype, n
                assert _rel(r[n], c[n].float().numpy()) <= tol, n
            continue
        assert np.array_equal(c["pos"].numpy(), r["pos"])
        for n in ("k", "v"):
            assert c[n].shape == r[n].shape and c[n].dtype == model.embed.dtype
            assert _rel(r[n], c[n].float().numpy()) <= TOL[dtype]


# A bf16 MoE model's hidden states differ between the two packages by
# rounding (about 1% of max |logits|), so a token whose k-th and (k + 1)-th
# router probabilities lie closer than that may take another expert in one
# of them, and every later position of its sequence attends to the change
# (reduced qwen3-moe, seed 1: position 13 of sequence 0, margin 0.0011, off
# by 0.34 of max |logits|).  In f32 (CASES) the two route alike and every
# position is held at 1e-4.
MARGIN = 5e-3  # router margins below this are near-ties at bf16's noise


def _min_router_margins(monkeypatch, run, k: int) -> np.ndarray:
    """Run ``run()``; each token's smallest top-k margin (p_k - p_{k+1})
    over the MoE layers of the pass, in token order of the pass."""
    from repro_torch.models import layers as L

    seen, route = [], L.route

    def recording(xf, router, kk):
        probs, weights, ids = route(xf, router, kk)
        top = torch.sort(probs, dim=-1, descending=True).values
        seen.append((top[:, k - 1] - top[:, k]).numpy())
        return probs, weights, ids

    monkeypatch.setattr(L, "route", recording)
    run()
    return np.min(np.stack(seen), axis=0)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_forward_in_bf16_matches_reference_where_routing_is_stable(name, monkeypatch):
    """bf16 MoE at 8.0 (no assignment dropped, so a moved token moves no
    other token's drop): every position of a sequence before its first
    near-tie (a router margin below MARGIN at some layer, in the port's
    pass) within 2e-2 of the reference, and a third of the positions at
    least compared; the prefill + decode contract within 2e-2 on the port
    alone, where the near-ties fall alike."""
    rcfg, params, cfg, model = _pair(name, "bfloat16", capacity_factor=CONTRACT_CAPACITY)
    toks = _tokens(cfg, T + 1)
    want, _, _ = ref_forward(params, rcfg, jnp.asarray(toks))
    got = []
    margins = _min_router_margins(monkeypatch, lambda: got.append(forward(model, torch.from_numpy(toks))[0]),
                                  cfg.experts_per_token).reshape(B, T + 1)
    stable = np.cumsum(margins < MARGIN, axis=1) == 0
    assert stable.sum() >= stable.size / 3
    w, g = np.asarray(want, np.float32), got[0].numpy()
    err = np.abs(w - g).max(-1) / np.abs(w).max()
    assert err[stable].max() <= TOL["bfloat16"]
    _, cache = forward(model, torch.from_numpy(toks[:, :T]), want_cache=True, cache_len=T + 8)
    dec, _ = decode_step(model, cache, torch.from_numpy(toks[:, T:]), torch.full((B,), T, dtype=torch.int32))
    assert _rel(g[:, T], dec[:, 0].numpy()) <= 2e-2


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


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma2-9b", "mistral-large-123b", "deepseek-67b",
                                  "qwen3-moe-235b-a22b", "grok-1-314b", "rwkv6-1.6b", "recurrentgemma-2b",
                                  "hubert-xlarge", "qwen2-vl-72b"])
def test_param_count_matches_the_port(name):
    """At full size, on the meta device: the port's parameters are the
    reference's pytree, leaf for leaf in count; ``param_count()`` is exact
    for models without post-norms or q/k norms and, as the reference's own
    test allows, within 2% for gemma2 (its analytic count leaves the
    post-norms out), the recurrent models (it counts their small vectors
    loosely) and hubert (it leaves out ``frontend_proj``); qwen3-moe's count
    leaves out its q/k norm scales."""
    cfg = get_config(name)
    model = Transformer(cfg, seed=None, device="meta")
    n = sum(p.numel() for p in model.parameters())
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jax.eval_shape(
        lambda: ref_init_params(jax.random.PRNGKey(0), ref_config(name)))))
    assert n == ref
    if set(cfg.layer_kinds) & RECURRENT:
        assert abs(n - cfg.param_count()) / n < 0.02
    elif cfg.use_post_norm:
        assert n - cfg.param_count() == 2 * cfg.d_model * cfg.num_layers
        assert abs(n - cfg.param_count()) / n < 0.02
    elif cfg.frontend == "audio_frames":
        assert n - cfg.param_count() == cfg.frontend_dim * cfg.d_model
        assert abs(n - cfg.param_count()) / n < 0.02
    else:
        qk_norms = 2 * cfg.head_dim * cfg.num_layers if cfg.qk_norm else 0
        assert n == cfg.param_count() + qk_norms


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_builds(name):
    """Every config builds, every layer kind and both modality frontends:
    the audio frontend's ``frontend_proj`` (frontend_dim, D) beside the
    embedding, and nothing more for the vision frontend."""
    cfg = get_config(name).reduced()
    model = init_params(cfg, device="cpu")
    assert [b.kind for b in model.layers] == list(cfg.layer_kinds)
    names = dict(model.named_parameters())
    assert ("frontend_proj" in names) == (cfg.frontend == "audio_frames")
    if cfg.frontend == "audio_frames":
        assert names["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
        assert names["frontend_proj"].dtype == model.embed.dtype


def test_params_from_jax_carries_the_moe_subtree():
    """An MoE layer's ``moe`` subtree: the router in float32 and the experts
    in bf16, bit for bit, under the module's own names."""
    rcfg, params, cfg, _ = _pair("qwen3-moe-235b-a22b", "bfloat16", num_layers=3)
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    names = dict(Transformer(cfg, seed=None, device="cpu").named_parameters())
    assert sorted(sd) == sorted(names)
    assert sum(t.numel() for t in sd.values()) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    E, D, Fe = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert sd["layers.1.moe.router"].dtype == torch.float32 and sd["layers.1.moe.router"].shape == (D, E)
    assert np.array_equal(sd["layers.1.moe.router"].numpy(), np.asarray(params["blocks"]["0"]["moe"]["router"][1]))
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16)
    for n, shape in (("wi", (E, D, Fe)), ("wg", (E, D, Fe)), ("wo", (E, Fe, D))):
        assert sd[f"layers.1.moe.{n}"].shape == shape and sd[f"layers.1.moe.{n}"].dtype == torch.bfloat16
        assert np.array_equal(bits(sd[f"layers.1.moe.{n}"]), np.asarray(params["blocks"]["0"]["moe"][n][1]).view(np.uint16))
    assert np.array_equal(bits(sd["layers.2.moe.wo"]), np.asarray(params["tail"]["0"]["moe"]["wo"]).view(np.uint16)) \
        if params["tail"] else True
    assert not any(".mlp." in n for n in sd)


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


def test_params_from_jax_carries_the_recurrent_subtrees():
    """recurrentgemma at 8 layers: two repetitions of (rglru, rglru, local)
    and a tail of two rglru layers, whose ``rec`` and ``mlp`` subtrees
    travel bit for bit; rwkv's ``tm`` (with ``tm.out_norm``) and ``cm``."""
    rcfg, params, cfg, _ = _pair("recurrentgemma-2b", "bfloat16", num_layers=8)
    assert cfg.layer_kinds[6:] == ("rglru", "rglru") and sorted(params["tail"]) == ["0", "1"]
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    names = dict(Transformer(cfg, seed=None, device="cpu").named_parameters())
    assert sorted(sd) == sorted(names)
    assert sum(t.numel() for t in sd.values()) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16)  # noqa: E731
    for j in (0, 1):
        tail = params["tail"][str(j)]
        for n, a in tail["rec"].items():
            got = sd[f"layers.{6 + j}.rec.{n}"]
            assert got.dtype == names[f"layers.{6 + j}.rec.{n}"].dtype, n
            a = np.asarray(a)
            assert np.array_equal(bits(got), a.view(np.uint16)) if a.dtype.name == "bfloat16" else \
                np.array_equal(got.numpy(), a)
        for n in ("wi", "wg", "wo"):
            assert np.array_equal(bits(sd[f"layers.{6 + j}.mlp.{n}"]), np.asarray(tail["mlp"][n]).view(np.uint16))
    assert np.array_equal(bits(sd["layers.4.rec.w_r"]), np.asarray(params["blocks"]["1"]["rec"]["w_r"][1]).view(np.uint16))
    rcfg, params, cfg, _ = _pair("rwkv6-1.6b", "float32", d_model=128)
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(dict(Transformer(cfg, seed=None, device="cpu").named_parameters()))
    assert np.array_equal(sd["layers.1.tm.out_norm.scale"].numpy(),
                          np.asarray(params["blocks"]["0"]["tm"]["out_norm"]["scale"][1]))
    assert np.array_equal(sd["layers.1.tm.u"].numpy(), np.asarray(params["blocks"]["0"]["tm"]["u"][1]))
    assert np.array_equal(sd["layers.0.cm.wk"].numpy(), np.asarray(params["blocks"]["0"]["cm"]["wk"][0]))
