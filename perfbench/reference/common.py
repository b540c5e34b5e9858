"""Pieces the plain references share: the precision of their products, the
RMS norm, rotary angles, attention in blocks of queries, the masked
cross-entropy, and the training procedure the configurations state (AdamW
with global-norm clipping, a warmup-cosine schedule, decay by the stacked
layout, f32 gradient accumulation).

Plain PyTorch in float32.  Nothing here imports the program under test.
TF32 is switched off for every product (``no_tf32``), since on the card a
float32 matrix product may otherwise run in TF32.

``Precision`` decides how numbers are rounded: ``"f32"`` leaves them as
they are (the reference); ``"fp8"`` is the step below the bfloat16 the
configurations state: each operand of a product, and each weight served in
bfloat16 (as drawn, and again after each optimizer update), rounded to
float8 e4m3 with one scale a tensor (its largest magnitude onto 448).  The
fp8 form is the control of the comparison that decides ``correct``: it has
to fail.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


class Precision:
    """How a product's operands are rounded: ``"f32"`` or ``"fp8"``."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x's values at this precision (float32 holds them)."""
        if self.name == "f32":
            return x
        s = E4M3_MAX / x.detach().abs().amax().clamp(min=1e-30)
        return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand: rounded in the forward, the gradient
        passing straight through."""
        if self.name == "f32":
            return x
        return x + (self.round(x) - x).detach()

    @torch.no_grad()
    def store(self, P: dict[str, torch.Tensor], served: dict[str, str]) -> None:
        """Round in place each weight served in bfloat16."""
        if self.name != "f32":
            for n, t in P.items():
                if served[n] == "bfloat16":
                    t.copy_(self.round(t))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self.q(a), self.q(b))


@contextlib.contextmanager
def no_tf32():
    """Every float32 product in full float32 while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + scale) over the last axis."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, T, N, hd) at positions 0..T-1, the pairs
    interleaved (channels 2i and 2i+1 rotate together)."""
    B, T, N, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None]  # (T, hd/2)
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * c - odd * s, odd * c + even * s], dim=-1).reshape(B, T, N, hd)


def _attend_block(q, k, v, q0: int, prec: Precision):
    """Causal softmax attention of queries q0.. (q (B, Tq, H, hd)) over k, v
    (B, S, H, hd) -> (B, Tq, H, hd)."""
    hd = q.shape[-1]
    Tq, S = q.shape[1], k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", prec.q(q), prec.q(k)) / math.sqrt(hd)
    rows = torch.arange(q0, q0 + Tq, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    s = s.masked_fill(cols > rows, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", prec.q(p), prec.q(v))


def causal_attention(q, k, v, prec: Precision, *, block_elems: int = 1 << 28) -> torch.Tensor:
    """Causal GQA attention: q (B, T, H, hd), k, v (B, T, KV, hd) -> (B, T,
    H, hd).  Queries go in blocks whose score matrix holds at most
    ``block_elems`` numbers, each block under ``checkpoint`` when autograd
    records it, so the scores are never all held at once."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    tq = max(1, min(T, block_elems // max(B * H * T, 1)))
    outs = []
    for q0 in range(0, T, tq):
        qb = q[:, q0:q0 + tq]
        kb, vb = k[:, :q0 + qb.shape[1]], v[:, :q0 + qb.shape[1]]
        if torch.is_grad_enabled() and q.requires_grad:
            outs.append(checkpoint(_attend_block, qb, kb, vb, q0, prec, use_reentrant=False))
        else:
            outs.append(_attend_block(qb, kb, vb, q0, prec))
    return torch.cat(outs, dim=1)


def cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, prec: Precision,
                  *, rows: int = 2048) -> torch.Tensor:
    """Mean masked cross-entropy of ``x @ head`` against labels, in blocks
    of ``rows`` tokens (each under ``checkpoint`` when autograd records it,
    so the whole logits are never held): x (N, D), labels, mask (N,)."""

    def block(xb, lb, mb):
        logits = prec.mm(xb, head)
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, lb[:, None])[:, 0]
        return (nll * mb).sum()

    total = x.new_zeros(())
    for i in range(0, x.shape[0], rows):
        args = (x[i:i + rows], labels[i:i + rows], mask[i:i + rows])
        total = total + (checkpoint(block, *args, use_reentrant=False) if torch.is_grad_enabled() else block(*args))
    return total / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# Training as the configurations state it
# ---------------------------------------------------------------------------


def lr_at(opt: dict, step: int) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_ratio * peak_lr`` at ``total_steps``."""
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * frac)))


def decays(name: str, shape: tuple[int, ...], n_stacked: int) -> bool:
    """Weight decay as the configurations state it: every tensor of a layer
    below ``n_stacked`` (the layers in whole repetitions of the pattern),
    and a tensor of two or more axes elsewhere."""
    parts = name.split(".")
    return (parts[0] == "layers" and int(parts[1]) < n_stacked) or len(shape) >= 2


CHUNK = 1 << 26  # elements a slice, so that no whole-leaf temporary is made


def slices(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def sq_norm(t: torch.Tensor) -> float:
    """The float64 sum of squares of a leaf, slice by slice."""
    return sum(s.double().pow(2).sum().item() for s in slices(t))


class AdamW:
    """AdamW in float32 over a dict of leaves, the moments starting at 0,
    each leaf updated slice by slice."""

    def __init__(self, params: dict[str, torch.Tensor], opt: dict, n_stacked: int):
        self.opt, self.t = opt, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.decay = {n: decays(n, tuple(p.shape), n_stacked) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> dict[str, float]:
        """One update in place; returns the global norm and the clip scale.
        ``grads`` are scaled in place by the clip."""
        o = self.opt
        self.t += 1
        gnorm = math.sqrt(sum(sq_norm(g) for g in grads.values()))
        scale = min(o["clip_norm"] / max(gnorm, 1e-9), 1.0)
        lr = lr_at(o, self.t)
        b1c, b2c = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        for n, p in params.items():
            for g, m, v, w in zip(slices(grads[n]), slices(self.m[n]), slices(self.v[n]), slices(p)):
                g.mul_(scale)
                m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                u = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
                if self.decay[n]:
                    u.add_(w, alpha=o["weight_decay"])
                w.sub_(u, alpha=lr)
        return {"grad_norm": gnorm, "scale": scale}


def train_readings(loss_of, params: dict[str, torch.Tensor], batches: list[dict], opt: dict, n_stacked: int,
                   accum: int, after_update=None) -> dict:
    """Run ``len(batches)`` optimizer steps of ``loss_of(params, mb) ->
    loss`` on ``params`` (f32 leaves, updated in place).  A batch of B rows
    is ``accum`` microbatches of B / accum rows; their gradients are summed
    in f32 and divided by ``accum``, and the step's loss is the mean of
    theirs; ``after_update(params)`` runs after each update.  Returns each
    step's loss and each leaf's norm of the first gradient as the optimizer
    takes it (clipped); the caller measures the change of ``params``."""
    for p in params.values():
        p.requires_grad_(True)
    adam = AdamW(params, opt, n_stacked)
    losses, first = [], None
    names = list(params)
    for batch in batches:
        B = batch["tokens"].shape[0]
        grads, total = None, 0.0
        for i in range(accum):
            mb = {k: v[i * B // accum:(i + 1) * B // accum] for k, v in batch.items()}
            loss = loss_of(params, mb)
            gs = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
            gs = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, gs)}
            total += loss.item()
            del loss
            if grads is None:
                grads = gs
            else:
                for n in names:
                    grads[n] += gs[n]
            del gs
        for g in grads.values():
            g /= accum
        adam.step(params, grads)
        if after_update is not None:
            after_update(params)
        if first is None:
            first = {n: math.sqrt(sq_norm(g)) for n, g in grads.items()}
        losses.append(total / accum)
        del grads
    del adam
    for p in params.values():
        p.requires_grad_(False)
    return {"loss": losses, "grad": first}


def silu(x):
    return F.silu(x)
