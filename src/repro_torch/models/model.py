"""Model assembly: a decoder of explicit layers, one module each.

Port of ``repro.models.model`` for the attention kinds ``dense``, ``local``,
``global`` and ``moe``.  The reference stacks the repetitions of the config's
``block_pattern`` and runs them with ``lax.scan``; here every layer is its
own ``Block`` in ``Transformer.layers``, in layer order (``cfg.
layer_kinds``), and a plain loop runs them.  ``models.convert`` maps the
reference's stacked parameters onto this layout.

Entry points:
  * ``init_params`` / ``Transformer(cfg, seed=..., device=None)`` - weights
    drawn from a ``torch.Generator`` seeded with ``seed`` on the device;
  * ``forward``     - prefill over T tokens (optionally building the decode
                      cache, optionally the head on the last position only);
  * ``decode_step`` - one token per sequence against the cache, which it
                      updates in place;
  * ``init_cache``  - an empty cache, one ``{k, v, pos}`` dict per layer.

Both passes run under ``torch.inference_mode()``.  An MoE layer's aux
loss is computed and dropped by the passes (training, ROADMAP Queue 1 item
7d, will carry it up).  The recurrent mixers (rwkv, rglru) and the
modality frontends raise ``NotImplementedError`` (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

ATTN_KINDS = ("dense", "local", "global", "moe")
_NOT_PORTED = {
    "rwkv": "rwkv layers are not ported yet (ROADMAP Queue 1 item 7b)",
    "rglru": "rglru layers are not ported yet (ROADMAP Queue 1 item 7b)",
}


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


class Block(nn.Module):
    """One attention layer: pre-norm attention and MLP (routed experts,
    ``moe``, on an MoE layer), with gemma2's post-norms when the config has
    them."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator | None, device=None):
        super().__init__()
        if kind in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[kind])
        if kind not in ATTN_KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.cfg, self.kind = cfg, kind
        D = cfg.d_model
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
    """The decoder: embedding, ``layers`` in layer order, final norm, head
    (tied to the embedding when the config says so).  ``seed=None`` leaves
    the weights uninitialised for a loader (``models.convert``).  The
    passes are the module functions ``forward`` and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, *, seed: int | None = 0, device=None):
        super().__init__()
        if cfg.frontend is not None:
            raise NotImplementedError(f"the {cfg.frontend} frontend is not ported yet (ROADMAP Queue 1 item 7c)")
        dev = resolve_device(device)
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
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
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])
    return L.build_cache(cfg, batch, max_len, local=(kind == "local"), device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list[dict[str, torch.Tensor]]:
    """Empty decode cache: one ``{k, v, pos}`` per layer, in layer order."""
    dev = resolve_device(device)
    return [init_layer_cache(cfg, kind, batch, max_len, dev) for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# Layers and passes
# ---------------------------------------------------------------------------


def apply_layer(block: Block, x, positions, cache=None, *, want_cache: bool = False, cache_len: int | None = None):
    """Returns (x, new_cache, aux).  ``cache=None`` with ``want_cache`` builds
    one from this (prefill) pass; a cache with one token (x (B, 1, D),
    positions (B,)) is a decode step, which updates the cache in place.
    ``aux`` is an MoE layer's load-balancing loss (0.0 for the others)."""
    cfg = block.cfg
    h = L.rms_norm(block.ln1, x, cfg.norm_eps)
    if cache is None or x.shape[1] != 1:  # prefill
        positions, cache = positions.expand(h.shape[:2]), None
    attn_out, new_cache = L.attention(block.attn, h, positions, cfg, local=(block.kind == "local"), cache=cache,
                                      want_cache=want_cache, cache_len=cache_len)
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


def _embed_inputs(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    x = torch.nn.functional.embedding(tokens, model.embed)
    if model.cfg.scale_embed:
        x = x * torch.tensor(model.cfg.d_model**0.5, dtype=x.dtype)
    return x


def _head(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = L.rms_norm(model.final_norm, x, cfg.norm_eps)
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (x @ w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


@torch.inference_mode()
def forward(model: Transformer, tokens, *, want_cache: bool = False, cache_len: int | None = None,
            last_only: bool = False):
    """Full-sequence forward (prefill) over tokens (B, T).

    Returns (logits, cache or None): logits (B, T, V) f32, or (B, 1, V) with
    ``last_only`` (the head applied to the last position alone: at T = 4096
    the full logits of llama3.2-3b would be 4.2 GB of f32).  ``cache_len``
    sizes the decode cache a prefill builds (>= T + tokens still to decode).
    """
    tokens = torch.as_tensor(tokens, device=model.device)
    x = _embed_inputs(model, tokens)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    caches = [] if want_cache else None
    for block in model.layers:
        x, c, _ = apply_layer(block, x, positions, want_cache=want_cache, cache_len=cache_len)
        if want_cache:
            caches.append(c)
    if last_only:
        x = x[:, -1:]
    return _head(model, x), caches


@torch.inference_mode()
def decode_step(model: Transformer, cache: list, tokens, positions):
    """One decode step.  tokens (B, 1); positions (B,) int32, the tokens'
    positions.  Writes them into ``cache`` in place; returns (logits (B, 1, V),
    cache)."""
    if not model.cfg.has_decode:
        raise ValueError(f"{model.cfg.name} is an encoder: it has no decode step")
    x = _embed_inputs(model, torch.as_tensor(tokens, device=model.device))
    positions = torch.as_tensor(positions, dtype=torch.int32, device=model.device)
    for block, c in zip(model.layers, cache):
        x, _, _ = apply_layer(block, x, positions, c)
    return _head(model, x), cache
