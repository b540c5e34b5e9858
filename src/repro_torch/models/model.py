"""Model assembly: a decoder of explicit layers, one module each.

Port of ``repro.models.model`` for the attention kinds ``dense``, ``local``,
``global`` and ``moe`` and the recurrent kinds ``rwkv`` and ``rglru``
(``models.recurrent``).  The reference stacks the repetitions of the config's
``block_pattern`` and runs them with ``lax.scan``; here every layer is its
own ``Block`` in ``Transformer.layers``, in layer order (``cfg.
layer_kinds``), and a plain loop runs them.  ``models.convert`` maps the
reference's stacked parameters onto this layout.

Entry points:
  * ``init_params`` / ``Transformer(cfg, seed=..., device=None)`` - weights
    drawn from a ``torch.Generator`` seeded with ``seed`` on the device;
  * ``forward``     - prefill over T tokens, or T audio frames (optionally
                      building the decode cache, optionally the head on the
                      last position only);
  * ``decode_step`` - one token per sequence against the cache, which it
                      updates in place;
  * ``init_cache``  - an empty cache, one dict per layer: ``{k, v, pos}``
                      for an attention layer, the recurrent state
                      (``{shift, wkv, cm_shift}``, ``{h, conv}``) for an
                      rwkv or rglru layer.

Both passes run under ``torch.inference_mode()``.  A prefill starts every
recurrent layer from the zero state; a decode step writes each layer's
new state into the cache's tensors in place, as it writes an attention
layer's k, v and position.  An MoE layer's aux loss is computed and
dropped by the passes (training, ROADMAP Queue 1 item 7d, will carry it
up).

The modality frontends are the reference's stubs.  ``audio_frames``
(hubert-xlarge, an encoder): precomputed frame features (B, T,
``frontend_dim``) are projected by ``frontend_proj`` in place of the token
embedding, which the model still holds, unused, as the reference's pytree
does.  ``vision_patches`` (qwen2-vl-72b): patch embeddings (B, P, D) are
added on the first P positions, and the rotary angles come from M-RoPE's
(3, B, T) position rows.  Those rows reach the rotation alone: the cache's
positions, its slots and flash's mask take the sequence positions.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

ATTN_KINDS = ("dense", "local", "global", "moe")
RECURRENT_KINDS = ("rwkv", "rglru")


class _Params(nn.Module):
    """A module whose tensors the layer functions read as ``p["name"]``."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def _register(self, tensors: dict[str, torch.Tensor]) -> None:
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class RMSNorm(_Params):
    def __init__(self, d: int, device=None):
        super().__init__()
        self._register(L.init_rmsnorm(d, device))


class Attention(_Params):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None, device=None):
        super().__init__()
        self._register(L.init_attention(cfg, gen, device))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, device)
            self.k_norm = RMSNorm(cfg.head_dim, device)


class MLP(_Params):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None, device=None):
        super().__init__()
        self._register(L.init_mlp(cfg, gen, device))


class MoE(_Params):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None, device=None):
        super().__init__()
        self._register(L.init_moe(cfg, gen, device))


class TimeMix(_Params):
    """An rwkv layer's time mix, with its RMS norm over D (``out_norm``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None, device=None):
        super().__init__()
        self._register(R.init_rwkv_time_mix(cfg, gen, device))
        self.out_norm = RMSNorm(cfg.d_model, device)


class ChannelMix(_Params):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None, device=None):
        super().__init__()
        self._register(R.init_rwkv_channel_mix(cfg, gen, device))


class RGLRU(_Params):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None, device=None):
        super().__init__()
        self._register(R.init_rglru_block(cfg, gen, device))


class Block(nn.Module):
    """One layer.  Attention kinds: pre-norm attention and MLP (routed
    experts, ``moe``, on an MoE layer), with gemma2's post-norms when the
    config has them.  ``rwkv``: pre-norm time mix (``tm``) and channel mix
    (``cm``).  ``rglru``: pre-norm RG-LRU block (``rec``) and MLP.  The
    submodules carry the reference's subtree names."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator | None, device=None):
        super().__init__()
        if kind not in ATTN_KINDS + RECURRENT_KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.cfg, self.kind = cfg, kind
        D = cfg.d_model
        if kind == "rwkv":
            self.ln1, self.tm = RMSNorm(D, device), TimeMix(cfg, gen, device)
            self.ln2, self.cm = RMSNorm(D, device), ChannelMix(cfg, gen, device)
            return
        if kind == "rglru":
            self.ln1, self.rec = RMSNorm(D, device), RGLRU(cfg, gen, device)
            self.ln2, self.mlp = RMSNorm(D, device), MLP(cfg, gen, device)
            return
        self.ln1 = RMSNorm(D, device)
        self.attn = Attention(cfg, gen, device)
        self.ln2 = RMSNorm(D, device)
        if kind == "moe":
            self.moe = MoE(cfg, gen, device)
        else:
            self.mlp = MLP(cfg, gen, device)
        if cfg.use_post_norm:
            self.ln1_post = RMSNorm(D, device)
            self.ln2_post = RMSNorm(D, device)


class Transformer(nn.Module):
    """The decoder: embedding (and ``frontend_proj`` for audio frames),
    ``layers`` in layer order, final norm, head (tied to the embedding when
    the config says so).  ``seed=None`` leaves the weights uninitialised
    for a loader (``models.convert``).  The passes are the module functions
    ``forward`` and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, *, seed: int | None = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        if cfg.frontend == "audio_frames":
            self.frontend_proj = nn.Parameter(L._normal(gen, (cfg.frontend_dim, D), cfg.frontend_dim**-0.5,
                                                        L.cdtype(cfg), dev), requires_grad=False)
        self.embed = nn.Parameter(L._normal(gen, (V, D), D**-0.5, L.cdtype(cfg), dev), requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, kind, gen, dev) for kind in cfg.layer_kinds)
        self.final_norm = RMSNorm(D, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(L._normal(gen, (D, V), D**-0.5, L.cdtype(cfg), dev), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """The model with weights drawn from ``seed`` on ``device`` (default: the
    CUDA card; raises without one)."""
    return Transformer(cfg, seed=seed, device=device).eval()


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device=None):
    if kind == "rwkv":
        return R.init_rwkv_state(cfg, batch, device)
    if kind == "rglru":
        return R.init_rglru_state(cfg, batch, device)
    return L.build_cache(cfg, batch, max_len, local=(kind == "local"), device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list[dict[str, torch.Tensor]]:
    """Empty decode cache, one dict per layer in layer order: ``{k, v,
    pos}`` for an attention layer, the zero state for a recurrent one."""
    dev = resolve_device(device)
    return [init_layer_cache(cfg, kind, batch, max_len, dev) for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# Layers and passes
# ---------------------------------------------------------------------------


def apply_layer(block: Block, x, positions, cache=None, *, want_cache: bool = False, cache_len: int | None = None,
                mrope_positions=None):
    """Returns (x, new_cache, aux).  ``cache=None`` with ``want_cache`` builds
    one from this (prefill) pass; a cache with one token (x (B, 1, D),
    positions (B,)) is a decode step, which updates the cache in place.
    ``mrope_positions`` (3, B, T) drive M-RoPE's angles only; the cache and
    the mask take ``positions``.  ``aux`` is an MoE layer's load-balancing
    loss (0.0 for the others)."""
    cfg = block.cfg
    if block.kind in RECURRENT_KINDS:
        return _apply_recurrent(block, x, cache, want_cache=want_cache)
    h = L.rms_norm(block.ln1, x, cfg.norm_eps)
    if cache is None or x.shape[1] != 1:  # prefill
        positions, cache = positions.expand(h.shape[:2]), None
    attn_out, new_cache = L.attention(block.attn, h, positions, cfg, local=(block.kind == "local"), cache=cache,
                                      want_cache=want_cache, cache_len=cache_len, mrope_positions=mrope_positions)
    if cfg.use_post_norm:
        attn_out = L.rms_norm(block.ln1_post, attn_out, cfg.norm_eps)
    x = x + attn_out
    h = L.rms_norm(block.ln2, x, cfg.norm_eps)
    if block.kind == "moe":
        ff, aux = L.moe(block.moe, h, cfg)
    else:
        ff, aux = L.mlp(block.mlp, h, cfg.mlp_activation), 0.0
    if cfg.use_post_norm:
        ff = L.rms_norm(block.ln2_post, ff, cfg.norm_eps)
    return x + ff, new_cache, aux


def _apply_recurrent(block: Block, x, cache, *, want_cache: bool):
    """An rwkv or rglru layer (``repro.models.model.apply_layer``'s recurrent
    kinds).  A prefill starts from the zero state and, with ``want_cache``,
    returns the new state; a decode step (a cache and one token) starts from
    the cache's state and copies the new one into its tensors in place."""
    cfg = block.cfg
    decode = cache is not None and x.shape[1] == 1
    B = x.shape[0]
    h = L.rms_norm(block.ln1, x, cfg.norm_eps)
    if block.kind == "rwkv":
        state = cache if decode else R.init_rwkv_state(cfg, B, x.device)
        tm_out, tm_state = R.rwkv_time_mix(block.tm, h, cfg, {"shift": state["shift"], "wkv": state["wkv"]})
        x = x + tm_out
        h = L.rms_norm(block.ln2, x, cfg.norm_eps)
        cm_out, cm_shift = R.rwkv_channel_mix(block.cm, h, cfg, state["cm_shift"])
        new_state = {"shift": tm_state["shift"], "wkv": tm_state["wkv"], "cm_shift": cm_shift}
        x = x + cm_out
    else:
        state = cache if decode else R.init_rglru_state(cfg, B, x.device)
        rec_out, new_state = R.rglru_block(block.rec, h, cfg, state)
        x = x + rec_out
        h = L.rms_norm(block.ln2, x, cfg.norm_eps)
        x = x + L.mlp(block.mlp, h, cfg.mlp_activation)
    if decode:
        for name, t in new_state.items():
            cache[name].copy_(t)
        return x, cache, 0.0
    return x, ({n: t.contiguous() for n, t in new_state.items()} if want_cache else None), 0.0


def _embed_inputs(model: Transformer, tokens, features, patch_embeds) -> torch.Tensor:
    """Audio frames projected by ``frontend_proj``; else the tokens'
    embedding (scaled where the config says so), with ``patch_embeds``
    added on the first P positions."""
    cfg, dev = model.cfg, model.device
    if cfg.frontend == "audio_frames":
        return torch.as_tensor(features, device=dev).to(L.cdtype(cfg)) @ model.frontend_proj
    x = torch.nn.functional.embedding(torch.as_tensor(tokens, device=dev), model.embed)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    if patch_embeds is not None:
        patch = torch.as_tensor(patch_embeds, device=dev)
        P = patch.shape[1]
        x = torch.cat([x[:, :P] + patch.to(x.dtype), x[:, P:]], dim=1)
    return x


def _mrope_rows(mrope_positions, dev):
    return None if mrope_positions is None else torch.as_tensor(mrope_positions, dtype=torch.int32, device=dev)


def _head(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = L.rms_norm(model.final_norm, x, cfg.norm_eps)
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (x @ w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


@torch.inference_mode()
def forward(model: Transformer, tokens=None, *, features=None, patch_embeds=None, mrope_positions=None,
            want_cache: bool = False, cache_len: int | None = None, last_only: bool = False):
    """Full-sequence forward (prefill) over tokens (B, T), or over audio
    frames ``features`` (B, T, frontend_dim); a vision model also takes
    ``patch_embeds`` (B, P, D) and ``mrope_positions`` (3, B, T).

    Returns (logits, cache or None): logits (B, T, V) f32, or (B, 1, V) with
    ``last_only`` (the head applied to the last position alone: at T = 4096
    the full logits of llama3.2-3b would be 4.2 GB of f32).  ``cache_len``
    sizes the decode cache a prefill builds (>= T + tokens still to decode).
    """
    x = _embed_inputs(model, tokens, features, patch_embeds)
    B, T = x.shape[:2]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    rows = _mrope_rows(mrope_positions, x.device)
    caches = [] if want_cache else None
    for block in model.layers:
        x, c, _ = apply_layer(block, x, positions, want_cache=want_cache, cache_len=cache_len, mrope_positions=rows)
        if want_cache:
            caches.append(c)
    if last_only:
        x = x[:, -1:]
    return _head(model, x), caches


@torch.inference_mode()
def decode_step(model: Transformer, cache: list, tokens, positions, *, mrope_positions=None):
    """One decode step.  tokens (B, 1); positions (B,) int32, the tokens'
    positions; a vision model's ``mrope_positions`` (3, B, 1).  Writes the
    tokens into ``cache`` in place at ``positions``; returns (logits (B, 1,
    V), cache)."""
    if not model.cfg.has_decode:
        raise ValueError(f"{model.cfg.name} is an encoder: it has no decode step")
    x = _embed_inputs(model, tokens, None, None)
    positions = torch.as_tensor(positions, dtype=torch.int32, device=model.device)
    rows = _mrope_rows(mrope_positions, model.device)
    for block, c in zip(model.layers, cache):
        x, _, _ = apply_layer(block, x, positions, c, mrope_positions=rows)
    return _head(model, x), cache
