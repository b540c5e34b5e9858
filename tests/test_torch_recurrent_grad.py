"""The recurrences' gradients in the port against autograd, float64 and the
reference's, on the CPU.

``rglru_scan_bwd.rglru_scan_bwd_plain`` against autograd through
``rglru_scan_plain`` (bit for bit: the same multiplies and adds in the same
order) and against ``jax.vjp`` of the reference's ``associative_scan``
(``repro/models/recurrent.py:rglru_block``), within 1e-5 of each
gradient's max.  ``rwkv_wkv_bwd.wkv_bwd_plain`` against autograd through
``wkv_plain`` (the reference's chunk form), against a float64 token-order
loop, and, through the time mix, against ``jax.vjp`` of the reference's
``rwkv_time_mix`` (its ``lax.scan`` of ``chunk_step``): within 1e-5 of
each gradient's max, at T not a multiple of 64, T = 1, logw at the clamp,
from a nonzero S0 and with a nonzero dS.

The two autograd functions of the card's path (``RWKVWKV``, ``RGLRUScan``)
run here with ``ops._route`` true and their kernel calls replaced by the
plain versions: the same as autograd through the plain forwards, and the
reduced models' whole gradients through them the same as the CPU path's
within 1e-5 of each leaf's max (the WKV and flash backwards' plain
versions sum in other orders than autograd does)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as RR
from repro_torch.kernels import flash, flash_bwd, ops, rglru_scan, rglru_scan_bwd, rwkv_wkv, rwkv_wkv_bwd
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.kernels.rglru_scan_bwd import rglru_scan_bwd_plain
from repro_torch.kernels.rwkv_wkv import wkv_plain
from repro_torch.kernels.rwkv_wkv_bwd import wkv_bwd_chunk_plain, wkv_bwd_plain
from repro_torch.models import recurrent as PR
from test_torch_cuda import rglru_inputs, wkv_clamp_inputs, wkv_inputs
from test_torch_recurrent import B, _cfgs, _torch_tree, _with_mu, _x

TOL = 1e-5  # of each gradient's max |g|


def _rel(want, got) -> float:
    w = np.asarray(want, np.float64)
    return float(np.abs(w - np.asarray(got, np.float64)).max() / (np.abs(w).max() + 1e-30))


def _leaves(tree: dict, prefix: str = "") -> dict:
    """A (nested) parameter tree's tensors by dotted name, made leaves of
    autograd (in place: the tree holds them)."""
    out = {}
    for n, t in tree.items():
        out.update(_leaves(t, f"{prefix}{n}.") if isinstance(t, dict) else {prefix + n: t.requires_grad_()})
    return out


def _at(tree, name: str):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


def _grads(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 37, 300])
def test_rglru_scan_bwd_plain_matches_autograd_and_reference(T):
    a, b, h0 = rglru_inputs(3, T, 70, seed=T)
    dh_seq, dh_last = _grads(T, (3, T, 70), (3, 70))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (a, b, h0)]
    h_seq, h_last = rglru_scan_plain(*leaves)
    want = torch.autograd.grad((h_seq, h_last), leaves, (torch.from_numpy(dh_seq), torch.from_numpy(dh_last)))
    got = rglru_scan_bwd_plain(*(torch.from_numpy(x) for x in (a, h0)), h_seq.detach(), torch.from_numpy(dh_seq),
                               torch.from_numpy(dh_last))
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    def combine(x, y):  # repro/models/recurrent.py:rglru_block
        a1, u1 = x
        a2, u2 = y
        return a1 * a2, a2 * u1 + u2

    def tree(a, b, h0):
        a0 = jnp.concatenate([jnp.ones((3, 1, 70), jnp.float32), a], axis=1)
        b0 = jnp.concatenate([h0[:, None], b], axis=1)
        _, h_all = jax.lax.associative_scan(combine, (a0, b0), axis=1)
        return h_all[:, 1:], h_all[:, -1]

    _, vjp = jax.vjp(tree, jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    for g, w in zip(got, vjp((jnp.asarray(dh_seq), jnp.asarray(dh_last)))):
        assert _rel(np.asarray(w), g.numpy()) <= TOL


# ---------------------------------------------------------------------------
# WKV
# ---------------------------------------------------------------------------


def _wkv_bwd_f64(r, k, v, logw, u, S0, do, dS):
    """The WKV recurrence's gradient token by token in float64 numpy."""
    T = r.shape[1]
    w = np.exp(logw)
    S, states = S0, []
    for t in range(T):
        states.append(S)
        S = w[:, t, ..., None] * S + np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
    dov = np.einsum("bthv,bthv->bth", do, v)
    dr, dk, dv, dlogw = (np.zeros_like(r) for _ in range(4))
    du = np.zeros_like(u)
    for t in range(T - 1, -1, -1):
        dr[:, t] = np.einsum("bhkv,bhv->bhk", states[t], do[:, t]) + u * k[:, t] * dov[:, t, :, None]
        dk[:, t] = np.einsum("bhkv,bhv->bhk", dS, v[:, t]) + r[:, t] * u * dov[:, t, :, None]
        dv[:, t] = np.einsum("bhkv,bhk->bhv", dS, k[:, t]) + np.einsum("bhk,hk,bhk->bh", r[:, t], u, k[:, t])[
            ..., None] * do[:, t]
        dlogw[:, t] = w[:, t] * np.einsum("bhkv,bhkv->bhk", dS, states[t])
        du += np.einsum("bhk,bhk,bh->hk", r[:, t], k[:, t], dov[:, t])
        dS = w[:, t, ..., None] * dS + np.einsum("bhk,bhv->bhkv", r[:, t], do[:, t])
    return dr, dk, dv, dlogw, du, dS


@pytest.mark.parametrize("T,clamp", [pytest.param(T, False, id=str(T)) for T in (1, 37, 64, 130, 300)]
                         + [pytest.param(200, True, id="clamp-200")])
def test_wkv_bwd_plain_matches_autograd_and_float64(T, clamp):
    """From a nonzero S0 with a nonzero dS; ``clamp``: logw at -1.2 over
    every even chunk (the chunk form's largest exp(-c))."""
    args = (wkv_clamp_inputs if clamp else wkv_inputs)(2, T, 2, seed=T)
    do, dS = _grads(T + 1, (2, T, 2, 64), (2, 2, 64, 64))
    got = wkv_bwd_plain(*(torch.from_numpy(a) for a in (*args, do, dS)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    want = torch.autograd.grad(wkv_plain(*leaves), leaves, (torch.from_numpy(do), torch.from_numpy(dS)))
    exact = _wkv_bwd_f64(*(a.astype(np.float64) for a in (*args, do, dS)))
    for name, g, w, e in zip(("dr", "dk", "dv", "dlogw", "du", "dS0"), got, want, exact):
        assert g.shape == w.shape, name
        assert _rel(w.numpy(), g.numpy()) <= TOL, name
        assert _rel(e, g.numpy()) <= TOL, name


@pytest.mark.parametrize("T", [1, 37, 130])
def test_time_mix_gradient_through_the_plain_backward_matches_reference(T, monkeypatch):
    """``jax.vjp`` of the reference's ``rwkv_time_mix`` (two heads, from a
    nonzero WKV state, cotangents on the output and on the new state)
    against the port's time mix on the card's route, whose recurrence's
    backward is ``wkv_bwd_plain`` through ``RWKVWKV``: every parameter, x,
    and the state within 1e-5 of each gradient's max."""
    monkeypatch.setattr(ops, "_route", lambda t: True)
    monkeypatch.setattr(rwkv_wkv, "rwkv_wkv_cuda", wkv_plain)
    monkeypatch.setattr(rwkv_wkv_bwd, "rwkv_wkv_bwd_cuda", lambda *a, need, ckpt: wkv_bwd_plain(*a))
    rcfg, cfg = _cfgs("rwkv6-1.6b", "float32")
    p = _with_mu(RR.init_rwkv_time_mix(jax.random.PRNGKey(T), rcfg), 5, 3)
    p = {**p, "u": jnp.asarray(np.random.default_rng(T).standard_normal(p["u"].shape).astype(np.float32))}
    x, xt = _x((B, T, rcfg.d_model), "float32", T)
    s, st = _x((B, rcfg.d_model), "float32", 5)
    H, hd = RR.rwkv_heads(rcfg)
    S0 = np.random.default_rng(6).standard_normal((B, H, hd, hd)).astype(np.float32)
    ct_out, ct_S = _grads(7, (B, T, rcfg.d_model), (B, H, hd, hd))

    def ref(p, x, S0):
        out, state = RR.rwkv_time_mix(p, x, rcfg, {"shift": s, "wkv": S0})
        return out, state["wkv"]

    _, vjp = jax.vjp(ref, p, x, jnp.asarray(S0))
    gp, gx, gS = vjp((jnp.asarray(ct_out), jnp.asarray(ct_S)))
    tree = _torch_tree(p)
    leaves = _leaves(tree)
    xl, Sl = xt.clone().requires_grad_(), torch.from_numpy(S0).requires_grad_()
    out, state = PR.rwkv_time_mix(tree, xl, cfg, {"shift": st, "wkv": Sl})
    names = list(leaves)
    got = torch.autograd.grad((out, state["wkv"]), [leaves[n] for n in names] + [xl, Sl],
                              (torch.from_numpy(ct_out), torch.from_numpy(ct_S)))
    want = [_at(gp, n) for n in names] + [np.asarray(gx), np.asarray(gS)]
    for name, g, w in zip(names + ["x", "S0"], got, want):
        assert _rel(w, g.numpy()) <= TOL, name


@pytest.mark.parametrize("T", [1, 37])
def test_rglru_block_gradient_through_the_plain_backward_matches_reference(T, monkeypatch):
    """``jax.vjp`` of the reference's ``rglru_block`` (from a nonzero h)
    against the port's block on the card's route, whose recurrence's
    backward is ``rglru_scan_bwd_plain`` through ``RGLRUScan``: every
    parameter, x and h within 1e-5 of each gradient's max."""
    monkeypatch.setattr(ops, "_route", lambda t: True)
    monkeypatch.setattr(rglru_scan, "rglru_scan_cuda", rglru_scan_plain)
    monkeypatch.setattr(rglru_scan_bwd, "rglru_scan_bwd_cuda", lambda *a: rglru_scan_bwd_plain(*a[:5]))
    rcfg, cfg = _cfgs("recurrentgemma-2b", "float32")
    p = RR.init_rglru_block(jax.random.PRNGKey(T), rcfg)
    p = {**p, "conv_b": jnp.asarray(np.random.default_rng(T).standard_normal(p["conv_b"].shape).astype(np.float32))}
    R, cw = rcfg.rnn_width, rcfg.conv_width
    x, xt = _x((B, T, rcfg.d_model), "float32", 20 + T)
    conv, convt = _x((B, cw - 1, R), "float32", 21)
    h = np.random.default_rng(22).standard_normal((B, R)).astype(np.float32)
    ct_out, ct_h = _grads(23, (B, T, rcfg.d_model), (B, R))

    def ref(p, x, h):
        out, state = RR.rglru_block(p, x, rcfg, {"h": h, "conv": conv})
        return out, state["h"]

    _, vjp = jax.vjp(ref, p, x, jnp.asarray(h))
    gp, gx, gh = vjp((jnp.asarray(ct_out), jnp.asarray(ct_h)))
    tree = _torch_tree(p)
    leaves = _leaves(tree)
    xl, hl = xt.clone().requires_grad_(), torch.from_numpy(h).requires_grad_()
    out, state = PR.rglru_block(tree, xl, cfg, {"h": hl, "conv": convt})
    names = list(leaves)
    got = torch.autograd.grad((out, state["h"]), [leaves[n] for n in names] + [xl, hl],
                              (torch.from_numpy(ct_out), torch.from_numpy(ct_h)))
    want = [_at(gp, n) for n in names] + [np.asarray(gx), np.asarray(gh)]
    for name, g, w in zip(names + ["x", "h"], got, want):
        assert _rel(w, g.numpy()) <= TOL, name


# ---------------------------------------------------------------------------
# the autograd functions of the card's path
# ---------------------------------------------------------------------------


@pytest.fixture
def plain_kernels(monkeypatch):
    """The card's route on CPU tensors: ``ops._route`` true, each kernel
    call its plain version (the WKV backward's the chunk form, fed by the
    checkpoints the forward wrote), the recurrences' calls recorded (with
    the backwards' ``need``)."""
    calls = {"rwkv_wkv": 0, "rglru_scan": 0, "rwkv_wkv_bwd": [], "rglru_scan_bwd": []}

    def count(name, fn):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call

    def wkv_bwd(*a, need, ckpt):
        calls["rwkv_wkv_bwd"].append(tuple(need))
        return tuple(g if n else None for g, n in zip(wkv_bwd_chunk_plain(*a, ckpt), need))

    def lru_bwd(a, h0, h_seq, dh_seq, dh_last, need_a, need_b, need_h0):
        calls["rglru_scan_bwd"].append((need_a, need_b, need_h0))
        got = rglru_scan_bwd_plain(a, h0, h_seq, dh_seq, dh_last)
        return tuple(g if n else None for g, n in zip(got, (need_a, need_b, need_h0)))

    monkeypatch.setattr(ops, "_route", lambda t: True)
    monkeypatch.setattr(rwkv_wkv, "rwkv_wkv_cuda", count("rwkv_wkv", wkv_plain))
    monkeypatch.setattr(rglru_scan, "rglru_scan_cuda", count("rglru_scan", rglru_scan_plain))
    monkeypatch.setattr(rwkv_wkv_bwd, "rwkv_wkv_bwd_cuda", wkv_bwd)
    monkeypatch.setattr(rglru_scan_bwd, "rglru_scan_bwd_cuda", lru_bwd)
    monkeypatch.setattr(flash, "flash_attention_cuda", flash.flash_attention_plain)
    monkeypatch.setattr(flash, "flash_attention_lse_cuda", flash.flash_attention_lse_plain)
    monkeypatch.setattr(flash_bwd, "flash_bwd_cuda", flash_bwd.flash_attention_bwd_plain)
    return calls


def test_autograd_functions_equal_autograd_through_plain_forwards(plain_kernels):
    """``RWKVWKV`` and ``RGLRUScan``: one forward call and one backward call
    each, asking for what ``needs_input_grad`` asks; the WKV's gradients
    within 1e-5 of autograd through ``wkv_plain``, the RG-LRU's bit for
    bit; nothing recorded under no_grad."""
    args = [torch.from_numpy(a) for a in wkv_inputs(2, 70, 2, seed=3)]
    do, dS = (torch.from_numpy(g) for g in _grads(4, (2, 70, 2, 64), (2, 2, 64, 64)))
    for need in ((True,) * 6, (True, True, True, True, True, False), (False, True, False, True, False, False)):
        leaves = [a.clone().requires_grad_(n) for a, n in zip(args, need)]
        o, S = ops.rwkv_wkv(*leaves)
        grads = torch.autograd.grad((o, S), [t for t in leaves if t.requires_grad], (do, dS))
        assert plain_kernels["rwkv_wkv_bwd"][-1] == need
        plain = [a.clone().requires_grad_(n) for a, n in zip(args, need)]
        want = torch.autograd.grad(wkv_plain(*plain), [t for t in plain if t.requires_grad], (do, dS))
        for g, w in zip(grads, want):
            assert (g - w).abs().max().item() <= TOL * w.abs().max().item()
    assert plain_kernels["rwkv_wkv"] == 3 and len(plain_kernels["rwkv_wkv_bwd"]) == 3

    a, b, h0 = (torch.from_numpy(x) for x in rglru_inputs(2, 50, 70, seed=3))
    dh_seq, dh_last = (torch.from_numpy(g) for g in _grads(5, (2, 50, 70), (2, 70)))
    for need in ((True, True, True), (True, True, False), (False, True, False)):
        leaves = [t.clone().requires_grad_(n) for t, n in zip((a, b, h0), need)]
        h_seq, h_last = ops.rglru_scan(*leaves)
        grads = torch.autograd.grad((h_seq, h_last), [t for t in leaves if t.requires_grad], (dh_seq, dh_last))
        assert plain_kernels["rglru_scan_bwd"][-1] == need
        plain = [t.clone().requires_grad_(n) for t, n in zip((a, b, h0), need)]
        want = torch.autograd.grad(rglru_scan_plain(*plain), [t for t in plain if t.requires_grad],
                                   (dh_seq, dh_last))
        for g, w in zip(grads, want):
            assert torch.equal(g, w)
    with torch.no_grad():
        assert ops.rglru_scan(a.requires_grad_(), b, h0)[0].grad_fn is None
        assert ops.rwkv_wkv(args[0].requires_grad_(), *args[1:])[0].grad_fn is None
    assert plain_kernels["rglru_scan"] == 4 and len(plain_kernels["rglru_scan_bwd"]) == 3


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_reduced_model_gradients_through_the_autograd_functions_equal_the_plain_path(plain_kernels, monkeypatch,
                                                                                     name, remat):
    """The loss and every leaf's gradient of a reduced recurrent model
    (d_model 128: two RWKV heads) on the card's route against the CPU path:
    the loss equal, each leaf within 1e-5 of its max |g|; a backward call
    for each recurrent layer, a forward for each (two under remat)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models.model import init_params
    from repro_torch.train import init_train_state, make_loss_fn

    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", d_model=128, remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=70, global_batch=2, seed=1)).batch(0).items()}
    runs = {}
    for route in ("card", "plain"):
        if route == "plain":
            monkeypatch.setattr(ops, "_route", lambda t: False)
        model = init_params(cfg, seed=3, device="cpu")
        params = init_train_state(model)["params"]
        loss, _ = make_loss_fn(cfg)(model, batch)
        runs[route] = (loss.detach(), torch.autograd.grad(loss, list(params.values())), list(params))
    kernel = "rwkv_wkv" if name.startswith("rwkv") else "rglru_scan"
    n_rec = sum(k in ("rwkv", "rglru") for k in cfg.layer_kinds)
    assert plain_kernels[kernel] == (2 if remat else 1) * n_rec and len(plain_kernels[kernel + "_bwd"]) == n_rec
    (loss, grads, names), (want_loss, want, _) = runs["card"], runs["plain"]
    assert torch.equal(loss, want_loss)
    for n, g, w in zip(names, grads, want):
        assert (g - w).abs().max().item() <= TOL * w.abs().max().item(), n
