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


# Rows with no valid key: the forward gives them the mean of V over the S
# slots, so the gradient sends dO / S to every slot's dV (padded k_pos = -1
# slots included) and nothing to dQ or dK.  (B, H, KV, hd, q_pos, k_pos):
# the minimal input (row 0, at q_pos 0, sees no key), the same with two
# padded slots, and a group of three heads over two batch rows, one of
# which has no valid key at all
EMPTY_ROW_CASES = {
    "late-keys": (1, 1, 1, 16, [[0, 5]], [[1, 2, 3, 4]]),
    "padded": (1, 1, 1, 16, [[0, 5]], [[1, -1, 3, -1]]),
    "gqa": (2, 3, 1, 16, [[0, 2, 6], [1, 2, 3]], [[2, -1, 4, 5, 6], [-1, -1, -1, -1, -1]]),
}


@pytest.mark.parametrize("name", EMPTY_ROW_CASES)
def test_plain_backward_on_rows_with_no_valid_key(name):
    """The plain backward against autograd through ``flash_attention_plain``
    and ``jax.vjp`` of the reference (which pads nothing at S <= 1,024), f32,
    causal: with dO on the empty rows alone, dV within 1e-6 of max |dV| and
    dQ and dK exactly 0 on every side; with dO on every row, each gradient
    within the f32 tolerance.  lse is +inf on the empty rows and their dQ
    is 0."""
    B, H, KV, hd, qpos, kpos = EMPTY_ROW_CASES[name]
    qp, kp = np.asarray(qpos, np.int32), np.asarray(kpos, np.int32)
    T, S = qp.shape[1], kp.shape[1]
    rng = np.random.default_rng(0)
    arrs = [rng.normal(0, 1, s).astype(np.float32) for s in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                                                              (B, T, H, hd))]
    empty = ~((kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])).any(-1)  # (B, T)
    assert empty.any() and not empty.all()
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    tqp, tkp = torch.from_numpy(qp), torch.from_numpy(kp)
    kw = dict(causal=True, window=None, softcap=None)
    out, lse = flash.flash_attention_lse_plain(q, k, v, tqp, tkp, **kw)
    assert torch.equal(torch.isposinf(lse), torch.from_numpy(empty)[:, :, None].expand(B, T, H))
    for only_empty in (True, False):
        dout_np = arrs[3] * empty[:, :, None, None] if only_empty else arrs[3]
        dout = torch.from_numpy(np.ascontiguousarray(dout_np))
        got = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, tqp, tkp, **kw)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(flash.flash_attention_plain(*leaves, tqp, tkp, **kw), leaves, dout)
        _, vjp = jax.vjp(lambda q, k, v: ref_layers.flash_attention(q, k, v, jnp.asarray(qp), jnp.asarray(kp), **kw),
                         *(jnp.asarray(a) for a in arrs[:3]))
        ref = [np.asarray(g) for g in vjp(jnp.asarray(dout_np))]
        assert (got[0][torch.from_numpy(empty)] == 0).all()
        if only_empty:
            for g in (*got[:2], *auto[:2], *ref[:2]):
                assert not np.asarray(g).any()
            assert _rel(got[2].numpy(), auto[2].numpy()) <= 1e-6 and _rel(got[2].numpy(), ref[2]) <= 1e-6
        else:
            for g, a, r in zip(got, auto, ref):
                assert _rel(g.numpy(), a.numpy()) <= TOL["float32"] and _rel(g.numpy(), r) <= TOL["float32"]
