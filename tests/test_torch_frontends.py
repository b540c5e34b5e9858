"""The modality frontends of the port against the reference's, on the CPU.

hubert-xlarge (audio frames, an encoder) and qwen2-vl-72b (patch
embeddings and M-RoPE) at the reduced configs: the reference draws the
weights, ``models.convert.params_from_jax`` carries them across, and the
same inputs, made with numpy from a seed in the shapes of the reference's
builders (``tests/test_models.py:30-37``: bf16 frames (B, T, frontend_dim),
bf16 patch embeddings (B, num_patches, D), (3, B, T) int32 M-RoPE rows), go
through both.  The M-RoPE rows are Qwen2-VL's for an image of 2 x 4 merged
patches on the first 8 positions (t 0, h = row, w = col), the text after
it from max(rows, cols) on all three rows.  Tolerances on the logits,
relative to max |logits|: 1e-4 in float32, 2e-2 in bf16
(``tests/test_torch_models.py``'s).

At the reduced head_dim of 16 the config's sections (16, 24, 24) give all
8 frequency slots to the t row, so the cases also run with (2, 3, 3), where
every row reaches the angles."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.serve.engine import make_prefill_step as ref_prefill_step
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.model import Transformer, decode_step, forward, init_params
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from test_torch_cuda import grid_positions

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, T = 2, 16
GRID = (2, 4)  # the reduced num_patches (8) as rows x cols of merged patches


def _pair(name: str, dtype: str, **changes):
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **changes)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, params, cfg, load_params(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _bf16(shape, seed: int) -> np.ndarray:
    """N(0, 1) draws rounded to bf16, held as float32 (both packages cast
    them to the compute type)."""
    x = np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _vision_inputs(cfg, n: int) -> dict[str, np.ndarray]:
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return {"tokens": tokens, "patch_embeds": _bf16((B, cfg.num_patches, cfg.d_model), 2),
            "mrope_positions": grid_positions(B, n, *GRID)}


def _audio_inputs(cfg, n: int) -> dict[str, np.ndarray]:
    return {"features": _bf16((B, n, cfg.frontend_dim), 3)}


def _ref(inputs: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _port(inputs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_forward_matches_reference(dtype):
    rcfg, params, cfg, model = _pair("hubert-xlarge", dtype)
    inputs = _audio_inputs(cfg, T)
    want, cache, _ = ref_forward(params, rcfg, None, **_ref(inputs))
    got, got_cache = forward(model, **_port(inputs))
    assert cache is None and got_cache is None
    assert got.dtype == torch.float32 and got.shape == (B, T, cfg.vocab_size)
    assert _rel(want, got.numpy()) <= TOL[dtype]
    last, _ = forward(model, **_port(inputs), last_only=True)
    assert _rel(got[:, -1].numpy(), last[:, 0].numpy()) <= 1e-6


SECTIONS = [(2, 3, 3), None]  # None: the config's own (16, 24, 24)


@pytest.mark.parametrize("sections", SECTIONS, ids=["sections-2-3-3", "config-sections"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_vl_forward_and_decode_match_reference(dtype, sections):
    changes = {} if sections is None else {"mrope_sections": sections}
    rcfg, params, cfg, model = _pair("qwen2-vl-72b", dtype, **changes)
    inputs = _vision_inputs(cfg, T + 1)
    want, _, _ = ref_forward(params, rcfg, **_ref(inputs))
    got, _ = forward(model, **_port(inputs))
    assert got.shape == (B, T + 1, cfg.vocab_size)
    assert _rel(want, got.numpy()) <= TOL[dtype]

    pre = {"tokens": inputs["tokens"][:, :T], "patch_embeds": inputs["patch_embeds"],
           "mrope_positions": inputs["mrope_positions"][:, :, :T]}
    step = {"mrope_positions": inputs["mrope_positions"][:, :, T:]}
    nxt, at = inputs["tokens"][:, T:], np.full((B,), T, np.int32)
    _, rcache, _ = ref_forward(params, rcfg, want_cache=True, cache_len=T + 8, **_ref(pre))
    rdec, rcache = ref_decode_step(params, rcfg, rcache, jnp.asarray(nxt), jnp.asarray(at), **_ref(step))
    _, cache = forward(model, want_cache=True, cache_len=T + 8, **_port(pre))
    dec, cache = decode_step(model, cache, torch.from_numpy(nxt), torch.from_numpy(at), **_port(step))
    assert _rel(rdec, dec.numpy()) <= TOL[dtype]
    assert _rel(want[:, T], dec[:, 0].numpy()) <= 2e-2  # the cache contract, as the reference states it
    ref_cache = _unstack(rcfg, rcache)
    assert len(cache) == len(ref_cache) == cfg.num_layers
    for c, r in zip(cache, ref_cache):
        assert sorted(c) == sorted(r) == ["k", "pos", "v"]
        # the sequence positions 0..T, never the M-RoPE rows
        assert np.array_equal(c["pos"].numpy(), r["pos"])
        assert np.array_equal(c["pos"].numpy()[:, : T + 1], np.broadcast_to(np.arange(T + 1), (B, T + 1)))
        for n in ("k", "v"):
            assert c[n].shape == r[n].shape and c[n].dtype == model.embed.dtype
            assert _rel(r[n], c[n].float().numpy()) <= TOL[dtype]


def test_mrope_rows_reach_the_logits():
    """At sections (2, 3, 3) the grid's rows and the sequence index on all
    three rows give other logits, in both packages alike."""
    rcfg, params, cfg, model = _pair("qwen2-vl-72b", "float32", mrope_sections=(2, 3, 3))
    inputs = _vision_inputs(cfg, T)
    flat = dict(inputs, mrope_positions=np.ascontiguousarray(np.broadcast_to(np.arange(T), (3, B, T)), np.int32))
    grid, _ = forward(model, **_port(inputs))
    seq, _ = forward(model, **_port(flat))
    want_seq, _, _ = ref_forward(params, rcfg, **_ref(flat))
    assert _rel(want_seq, seq.numpy()) <= TOL["float32"]
    assert _rel(seq.numpy(), grid.numpy()) > 1e-2
    # the text tokens after the image see the rows; the first image token's
    # rows are (0, 0, 0) in both
    assert _rel(seq[:, 0].numpy(), grid[:, 0].numpy()) <= 1e-6


def test_params_from_jax_carries_frontend_proj():
    """hubert's ``frontend_proj`` (frontend_dim, D) bit for bit in bf16, and
    its unused ``embed``: the state_dicts match leaf for leaf."""
    rcfg, params, cfg, _ = _pair("hubert-xlarge", "bfloat16")
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    names = dict(Transformer(cfg, seed=None, device="cpu").named_parameters())
    assert sorted(sd) == sorted(names)
    assert sum(t.numel() for t in sd.values()) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    fp = sd["frontend_proj"]
    assert fp.dtype == torch.bfloat16 and fp.shape == (cfg.frontend_dim, cfg.d_model)
    assert np.array_equal(fp.view(torch.int16).numpy().view(np.uint16), np.asarray(params["frontend_proj"]).view(np.uint16))
    assert sd["embed"].shape == (cfg.vocab_size, cfg.d_model)


def test_frontend_proj_is_drawn_at_the_reference_scale():
    """The port's own draw: N(0, 1 / frontend_dim) in the compute type."""
    cfg = dataclasses.replace(get_config("hubert-xlarge").reduced(), frontend_dim=512)
    model = init_params(cfg, seed=0, device="cpu")
    std = model.frontend_proj.float().std().item()
    assert model.frontend_proj.dtype == torch.bfloat16
    assert abs(std * 512**0.5 - 1.0) < 0.05


def test_encoder_decode_step_raises():
    cfg = get_config("hubert-xlarge").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        decode_step(model, [], torch.zeros((B, 1), dtype=torch.int32), torch.zeros((B,), dtype=torch.int32))
    with pytest.raises(ValueError, match="encoder"):
        make_decode_step(cfg, device="cpu")(model, [], {"tokens": torch.zeros((B, 1), dtype=torch.int32),
                                                         "positions": torch.zeros((B,), dtype=torch.int32)})


@pytest.mark.parametrize("package", ["port", "reference"])
def test_the_last_frame_moves_the_first_position(package):
    """hubert is non-causal: a change of the last frame reaches the first
    position's logits."""
    rcfg, params, cfg, model = _pair("hubert-xlarge", "float32")
    a = _audio_inputs(cfg, T)["features"]
    b = a.copy()
    b[:, -1] += 1.0
    if package == "port":
        la, _ = forward(model, features=torch.from_numpy(a))
        lb, _ = forward(model, features=torch.from_numpy(b))
        la, lb = la.numpy(), lb.numpy()
    else:
        la = np.asarray(ref_forward(params, rcfg, None, features=jnp.asarray(a))[0])
        lb = np.asarray(ref_forward(params, rcfg, None, features=jnp.asarray(b))[0])
    assert _rel(la[:, 0], lb[:, 0]) > 1e-4


@pytest.mark.parametrize("name", ["hubert-xlarge", "qwen2-vl-72b"])
def test_prefill_step_with_the_inputs_dict_equals_forward(name):
    """``make_prefill_step``'s logits are forward's last position, as the
    reference's step gives them; the encoder's step builds no cache."""
    rcfg, params, cfg, model = _pair(name, "float32")
    inputs = _audio_inputs(cfg, T) if cfg.frontend == "audio_frames" else _vision_inputs(cfg, T)
    logits, cache = make_prefill_step(cfg, T + 4, device="cpu")(model, _port(inputs))
    full, _ = forward(model, **_port(inputs))
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.equal(logits, full[:, -1]) or _rel(full[:, -1].numpy(), logits.numpy()) <= 1e-6
    want, rcache = ref_prefill_step(rcfg, T + 4)(params, _ref(inputs))
    assert _rel(want, logits.numpy()) <= TOL["float32"]
    assert (cache is None) == (rcache is None) == (not cfg.has_decode)
    if cache is not None:
        assert [c["pos"].shape for c in cache] == [(B, T + 4)] * cfg.num_layers


@pytest.mark.parametrize("head_dim,sections", [(16, (16, 24, 24)), (16, (2, 3, 3)), (128, (16, 24, 24)),
                                               (16, (1, 2, 2)), (128, (8, 8, 8))],
                         ids=["hd16-config", "hd16-2-3-3", "hd128-config", "hd16-short", "hd128-short"])
def test_mrope_section_ids_follow_the_reference_at_any_head_dim(head_dim, sections):
    """``_rope_angles`` cuts or pads the section ids to head_dim // 2 as the
    reference's ``jnp.repeat(..., total_repeat_length=half)``: cut when the
    sections sum past it (hd 16 with (16, 24, 24), where the port raised a
    size mismatch), padded with the last id when they sum short."""
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)  # three distinct rows
    want = np.asarray(ref_layers._rope_angles(jnp.asarray(pos), head_dim, 1e6, sections))
    got = L._rope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert got.shape == want.shape == (2, 7, head_dim // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
