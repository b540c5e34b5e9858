"""The port's recurrent mixers against the reference's, on the CPU.

The reference draws each mixer's parameters (``repro.models.recurrent``'s
``init_*``, with the token-shift mixes ``mu`` redrawn nonzero so that the
shift is exercised) and they travel to the port as tensors; the same
inputs, made with numpy from a seed, go through both.  Tolerances, relative
to the largest magnitude of the output (and of each state tensor): 1e-4 in
float32 (the same arithmetic in another order), 2e-2 in bf16 (rounding at
other places).  d_model is 128, two RWKV heads, so a fault of the head
layout shows.  The plain recurrences are also held to float64 numpy
definitions, and the RG-LRU's to the reference's associative scan."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import recurrent as RR
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.kernels.rwkv_wkv import wkv_plain
from repro_torch.models import recurrent as PR
from repro_torch.models.convert import _tensor
from test_torch_cuda import rglru_inputs, wkv_clamp_inputs, wkv_inputs

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, D = 2, 128


def _cfgs(name: str, dtype: str):
    changes = dict(dtype=dtype, d_model=D)
    return (dataclasses.replace(ref_config(name).reduced(), **changes),
            dataclasses.replace(get_config(name).reduced(), **changes))


def _torch_tree(tree):
    return {n: _torch_tree(a) if isinstance(a, dict) else _tensor(np.asarray(a)) for n, a in tree.items()}


def _rel(want, got) -> float:
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(w - g).max() / (np.abs(w).max() + 1e-30))


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _x(shape, dtype: str, seed: int):
    """The same values in both packages: numpy, rounded once to dtype."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).astype(dtype)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))


def _with_mu(p: dict, rows: int, seed: int) -> dict:
    return {**p, "mu": jnp.asarray(np.random.default_rng(seed).random((rows, D)).astype(np.float32))}


def test_token_shift_matches_reference():
    for dtype in ("float32", "bfloat16"):
        x, xt = _x((B, 9, D), dtype, 0)
        s, st = _x((B, D), dtype, 1)
        mu = np.random.default_rng(2).random((5, D)).astype(np.float32)
        want = RR._token_shift(x, jnp.asarray(mu), s)
        got = PR._token_shift(xt, torch.from_numpy(mu), st)
        assert got.shape == (5, B, 9, D) and got.dtype == xt.dtype
        assert _rel(_f32(want), _f32(got)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [37, 64, 70, 1])  # padding, one whole chunk, a carried chunk, one step
def test_rwkv_time_mix_matches_reference(dtype, T):
    rcfg, cfg = _cfgs("rwkv6-1.6b", dtype)
    p = _with_mu(RR.init_rwkv_time_mix(jax.random.PRNGKey(T), rcfg), 5, 3)
    x, xt = _x((B, T, D), dtype, T)
    H, hd = RR.rwkv_heads(rcfg)
    assert PR.rwkv_heads(cfg) == (H, hd) == (2, 64)
    if T == 1:  # one step from a nonzero state
        s, st = _x((B, D), dtype, 5)
        S0 = np.random.default_rng(6).standard_normal((B, H, hd, hd)).astype(np.float32)
        state, pstate = {"shift": s, "wkv": jnp.asarray(S0)}, {"shift": st, "wkv": torch.from_numpy(S0)}
    else:
        z = RR.init_rwkv_state(rcfg, B)
        state, pstate = {"shift": z["shift"], "wkv": z["wkv"]}, {n: t for n, t in PR.init_rwkv_state(cfg, B).items()
                                                               if n != "cm_shift"}
    want, wstate = RR.rwkv_time_mix(p, x, rcfg, state)
    got, gstate = PR.rwkv_time_mix(_torch_tree(p), xt, cfg, pstate)
    assert got.dtype == xt.dtype and got.shape == (B, T, D)
    assert _rel(_f32(want), _f32(got)) <= TOL[dtype]
    assert gstate["wkv"].dtype == torch.float32 and gstate["shift"].dtype == xt.dtype
    for n in ("shift", "wkv"):
        assert _rel(_f32(wstate[n]), _f32(gstate[n])) <= TOL[dtype], n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_channel_mix_matches_reference(dtype):
    rcfg, cfg = _cfgs("rwkv6-1.6b", dtype)
    p = _with_mu(RR.init_rwkv_channel_mix(jax.random.PRNGKey(1), rcfg), 2, 4)
    x, xt = _x((B, 37, D), dtype, 7)
    s, st = _x((B, D), dtype, 8)
    want, wshift = RR.rwkv_channel_mix(p, x, rcfg, s)
    got, gshift = PR.rwkv_channel_mix(_torch_tree(p), xt, cfg, st)
    assert _rel(_f32(want), _f32(got)) <= TOL[dtype]
    assert np.array_equal(_f32(wshift), _f32(gshift))  # the input at the last position


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_carries_its_history(dtype):
    rcfg, cfg = _cfgs("recurrentgemma-2b", dtype)
    p = RR.init_rglru_block(jax.random.PRNGKey(2), rcfg)
    R, cw = rcfg.rnn_width, rcfg.conv_width
    b = np.random.default_rng(9).standard_normal(R).astype(np.float32)  # a nonzero bias, added last
    for T in (37, 1):
        x, xt = _x((B, T, R), dtype, 10 + T)
        buf, buft = _x((B, cw - 1, R), dtype, 11)
        want, wbuf = RR._causal_conv(x, p["conv_w"], jnp.asarray(b), buf)
        got, gbuf = PR._causal_conv(xt, _tensor(np.asarray(p["conv_w"])), torch.from_numpy(b), buft)
        assert got.dtype == xt.dtype and gbuf.shape == (B, cw - 1, R)
        assert _rel(_f32(want), _f32(got)) <= TOL[dtype]
        assert np.array_equal(_f32(wbuf), _f32(gbuf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [37, 1])
def test_rglru_block_matches_reference(dtype, T):
    rcfg, cfg = _cfgs("recurrentgemma-2b", dtype)
    p = RR.init_rglru_block(jax.random.PRNGKey(T), rcfg)
    R, cw = rcfg.rnn_width, rcfg.conv_width
    x, xt = _x((B, T, D), dtype, 20 + T)
    conv, convt = _x((B, cw - 1, R), dtype, 21)
    h = np.random.default_rng(22).standard_normal((B, R)).astype(np.float32)
    want, wstate = RR.rglru_block(p, x, rcfg, {"h": jnp.asarray(h), "conv": conv})
    got, gstate = PR.rglru_block(_torch_tree(p), xt, cfg, {"h": torch.from_numpy(h), "conv": convt})
    assert got.dtype == xt.dtype and got.shape == (B, T, D)
    assert _rel(_f32(want), _f32(got)) <= TOL[dtype]
    assert gstate["h"].dtype == torch.float32 and gstate["conv"].dtype == xt.dtype
    for n in ("h", "conv"):
        assert _rel(_f32(wstate[n]), _f32(gstate[n])) <= TOL[dtype], n


def test_recurrent_states_match_the_reference():
    for name, kind in (("rwkv6-1.6b", "rwkv"), ("recurrentgemma-2b", "rglru")):
        for dtype in ("float32", "bfloat16"):
            rcfg, cfg = _cfgs(name, dtype)
            want = RR.init_rwkv_state(rcfg, 3) if kind == "rwkv" else RR.init_rglru_state(rcfg, 3)
            got = PR.init_rwkv_state(cfg, 3) if kind == "rwkv" else PR.init_rglru_state(cfg, 3)
            assert sorted(want) == sorted(got)
            for n, a in want.items():
                assert tuple(a.shape) == tuple(got[n].shape) and str(a.dtype) == str(got[n].dtype).split(".")[1]
                assert not got[n].any()


def _wkv_f64(r, k, v, logw, u, S0):
    """The WKV recurrence token by token in float64 numpy."""
    Bn, T, H, hd = r.shape
    S, o = S0.astype(np.float64), np.zeros(r.shape)
    for t in range(T):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        o[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t], u[None, :, :, None] * kv + S)
        S = np.exp(logw[:, t])[..., None] * S + kv
    return o, S


@pytest.mark.parametrize("T,clamp", [pytest.param(T, False, id=str(T)) for T in (1, 37, 64, 70, 130)]
                         + [pytest.param(T, True, id=f"clamp-{T}") for T in (64, 200)])
def test_wkv_plain_is_the_recurrence(T, clamp):
    """The plain version (the reference's chunk form, its single step at
    T = 1) against the token recurrence in float64, two heads whose decays
    differ by channel, from a nonzero state; with ``clamp``, logw at -1.2
    over every even chunk (the largest exp(-c) the chunk form meets)."""
    args = (wkv_clamp_inputs if clamp else wkv_inputs)(2, T, 2, seed=T)
    o, S = wkv_plain(*(torch.from_numpy(a) for a in args))
    want_o, want_S = _wkv_f64(*(a.astype(np.float64) for a in args))
    assert _rel(want_o, o.numpy()) <= 1e-5 and _rel(want_S, S.numpy()) <= 1e-5


@pytest.mark.parametrize("T", [1, 37, 300])
def test_rglru_scan_plain_is_the_recurrence(T):
    """The plain scan against float64 numpy and against the reference's
    form, ``lax.associative_scan`` of its combine from h0 (float32 rounding
    apart)."""
    a, b, h0 = rglru_inputs(3, T, 70, seed=T)
    h_seq, h_last = rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    h, want = h0.astype(np.float64), []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert _rel(np.stack(want, 1), h_seq.numpy()) <= 1e-5
    assert np.array_equal(h_seq[:, -1].numpy(), h_last.numpy())

    def combine(x, y):  # repro/models/recurrent.py:rglru_block
        a1, u1 = x
        a2, u2 = y
        return a1 * a2, a2 * u1 + u2

    a0 = jnp.concatenate([jnp.ones((3, 1, 70), jnp.float32), jnp.asarray(a)], axis=1)
    b0 = jnp.concatenate([jnp.asarray(h0)[:, None], jnp.asarray(b)], axis=1)
    _, tree = jax.lax.associative_scan(combine, (a0, b0), axis=1)
    assert _rel(np.asarray(tree[:, 1:]), h_seq.numpy()) <= 1e-5
