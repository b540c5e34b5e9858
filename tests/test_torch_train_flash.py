"""flash attention's backward on the CPU: ``flash_attention_bwd_plain``
(the formulas the ``flash_bwd`` kernel computes) against autograd through
``flash_attention_plain`` and against ``jax.vjp`` of the reference's
``layers.flash_attention`` (its XLA path, which the reference trains
through), and the forward's log-sum-exp against ``jax.nn.logsumexp`` of the
reference's masked scores.

Inputs are N(0, 1) draws made with numpy from a seed.  Tolerances, of the
largest |gradient| of each output: f32 1e-5 (the same formulas summed in
another order); bf16 operands 2e-2 against the reference (its autodiff
rounds the chunk's scores, p and the products' operands to bf16 where the
plain version keeps f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.kernels import flash, flash_bwd, ops

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (B, T, H, KV, hd, causal, window, softcap); T = 1,100 is one chunk of
# 1,024 and a ragged second
CASES = [
    (2, 70, 4, 4, 16, True, None, None),
    (2, 70, 6, 2, 16, False, None, None),
    (2, 70, 6, 2, 16, True, 32, None),
    (2, 70, 8, 1, 16, True, None, 50.0),
    (1, 65, 8, 1, 64, False, 16, 30.0),
    (1, 1100, 3, 1, 16, True, 300, None),
]


def _inputs(case, dtype: str):
    B, T, H, KV, hd, causal, window, cap = case
    rng = np.random.default_rng(T + 7 * H + hd)
    arrs = [rng.normal(0, 1, s).astype(np.float32) for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                                                              (B, T, H, hd))]
    if dtype == "bfloat16":  # bf16 values, held as f32, so both packages start from the same numbers
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    return arrs, pos, dict(causal=causal, window=window, softcap=cap)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_grads(arrs, pos, kw, dtype: str):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, dout = (jnp.asarray(a, jdt) for a in arrs)
    p = jnp.asarray(pos)
    out, vjp = jax.vjp(lambda q, k, v: ref_layers.flash_attention(q, k, v, p, p, **kw), q, k, v)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(dout)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_autograd_and_the_reference(case, dtype):
    arrs, pos, kw = _inputs(case, dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v, dout = (torch.from_numpy(a).to(tdt) for a in arrs)
    p = torch.from_numpy(pos)
    out, lse = flash.flash_attention_lse_plain(q, k, v, p, p, **kw)
    got = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, p, p, **kw)
    assert all(g.dtype == tdt for g in got)
    for g, w in zip(got, _ref_grads(arrs, pos, kw, dtype)):
        assert _rel(g.float().numpy(), w) <= TOL[dtype]
    if dtype == "float32":
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(ops.flash_attention(*leaves, p, p, **kw), leaves, dout)
        for g, w in zip(got, auto):
            assert _rel(g.numpy(), w.numpy()) <= TOL[dtype]


@pytest.mark.parametrize("chunk", [16, 1024])
def test_plain_backward_does_not_depend_on_the_chunk(chunk):
    arrs, pos, kw = _inputs(CASES[2], "float32")
    q, k, v, dout = (torch.from_numpy(a) for a in arrs)
    p = torch.from_numpy(pos)
    out, lse = flash.flash_attention_lse_plain(q, k, v, p, p, **kw)
    want = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, p, p, **kw, kv_chunk=7)
    got = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, p, p, **kw, kv_chunk=chunk)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-6


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_lse_is_the_logsumexp_of_the_reference_scores(case):
    """lse = m + log(l) of the forward's online softmax against
    ``jax.nn.logsumexp`` of the reference's scaled, softcapped and masked
    (to -1e30) scores, within 1e-5 of max |lse|; the forward's output is
    ``flash_attention_plain``'s bit for bit."""
    arrs, pos, kw = _inputs(case, "float32")
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    p = torch.from_numpy(pos)
    out, lse = flash.flash_attention_lse_plain(q, k, v, p, p, **kw)
    assert torch.equal(out, flash.flash_attention_plain(q, k, v, p, p, **kw))
    G = q.shape[2] // k.shape[2]
    s = jnp.einsum("bthd,bshd->bths", jnp.asarray(arrs[0]), jnp.repeat(jnp.asarray(arrs[1]), G, axis=2))
    s = s * q.shape[-1] ** -0.5
    if kw["softcap"] is not None:
        s = kw["softcap"] * jnp.tanh(s / kw["softcap"])
    qp, kp = jnp.asarray(pos)[:, :, None], jnp.asarray(pos)[:, None, :]
    ok = kp >= 0
    if kw["causal"]:
        ok &= kp <= qp
    if kw["window"] is not None:
        ok &= kp > qp - kw["window"]
    want = jax.nn.logsumexp(jnp.where(ok[:, :, None, :], s, ref_layers.NEG_INF), axis=-1)
    assert _rel(lse.numpy(), np.asarray(want)) <= 1e-5
