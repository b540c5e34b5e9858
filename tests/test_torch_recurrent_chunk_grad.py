"""The WKV backward's chunk form, the algebra of ``csrc/rwkv_wkv_bwd.cu``,
in PyTorch on the CPU.

``rwkv_wkv_bwd.wkv_bwd_chunk_plain`` (chunks of 64 tokens, the factored
scalings, the reverse state pass, dlogw by the token identity summed from
each chunk's end), fed by the checkpoints that ``rwkv_wkv.wkv_plain``
writes, against ``wkv_bwd_plain`` (the token form), autograd through
``wkv_plain``, a float64 token-order loop and ``jax.vjp`` of the
reference's ``rwkv_time_mix`` (its ``lax.scan`` of ``chunk_step``), at T
not a multiple of 64, T = 1 and logw at the clamp (-1.2 over whole chunks:
exp(-c) reaches exp(76.8)).  Tolerance: 1e-4 of each output's max |want|,
the kernel's own against the token form (float32 sums in other orders);
the float64 rehearsal of the same form agrees to ~1e-15.  The checkpoints
are ``wkv_plain``'s own states: bit for bit those of its runs on the
prefixes of 64 c tokens, and the float64 token loop's within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as RR
from repro_torch.kernels import ops, rwkv_wkv, rwkv_wkv_bwd
from repro_torch.kernels.rwkv_wkv import checkpoint_shape, wkv_plain
from repro_torch.kernels.rwkv_wkv_bwd import wkv_bwd_chunk_plain, wkv_bwd_plain
from repro_torch.models import recurrent as PR
from test_torch_cuda import wkv_clamp_inputs, wkv_inputs
from test_torch_recurrent import B, _cfgs, _torch_tree, _with_mu, _x
from test_torch_recurrent_grad import _at, _grads, _leaves, _rel, _wkv_bwd_f64

TOL = 1e-4  # of each output's max |want|
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dS0")
CASES = [pytest.param(T, False, id=str(T)) for T in (1, 37, 64, 130, 300)] + [pytest.param(200, True, id="clamp-200")]


def _checkpoints(args) -> torch.Tensor:
    B_, T, H, _ = args[0].shape
    ckpt = torch.full(checkpoint_shape(B_, T, H), float("nan"))
    wkv_plain(*args, ckpt)
    return ckpt


@pytest.mark.parametrize("T", [1, 37, 64, 130, 300])
def test_wkv_plain_checkpoints_are_its_states(T):
    """The state after every chunk of 64 tokens, the last the final S: bit
    for bit ``wkv_plain``'s on the prefix, within 1e-5 of the float64 token
    loop's; ``o`` and ``S`` the same with and without ``ckpt``."""
    args = [torch.from_numpy(a) for a in wkv_inputs(2, T, 2, seed=T)]
    o, S = wkv_plain(*args)
    ckpt = torch.full(checkpoint_shape(2, T, 2), float("nan"))
    o2, S2 = wkv_plain(*args, ckpt)
    assert torch.equal(o, o2) and torch.equal(S, S2)
    assert ckpt.shape == (2, 2, -(-T // 64), 64, 64) and torch.equal(ckpt[:, :, -1], S)
    for c in range(ckpt.shape[2] - 1):
        _, want = wkv_plain(*(a[:, :64 * (c + 1)] for a in args[:4]), *args[4:])
        assert torch.equal(ckpt[:, :, c], want), c
    r, k, v, logw, u, S0 = (a.double().numpy() for a in args)
    Sf = S0
    for t in range(T):
        Sf = np.exp(logw[:, t])[..., None] * Sf + np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        if (t + 1) % 64 == 0 or t == T - 1:
            assert _rel(Sf, ckpt[:, :, t // 64].numpy()) <= 1e-5, t


@pytest.mark.parametrize("T,clamp", CASES)
def test_wkv_bwd_chunk_plain_matches_the_token_form_autograd_and_float64(T, clamp):
    """From a nonzero S0 with a nonzero dS, against ``wkv_bwd_plain``,
    autograd through ``wkv_plain`` and the float64 token loop."""
    args = (wkv_clamp_inputs if clamp else wkv_inputs)(2, T, 2, seed=T + 7)
    do, dS = _grads(T + 8, (2, T, 2, 64), (2, 2, 64, 64))
    ts = [torch.from_numpy(a) for a in (*args, do, dS)]
    got = wkv_bwd_chunk_plain(*ts, _checkpoints(ts[:6]))
    token = wkv_bwd_plain(*ts)
    leaves = [t.clone().requires_grad_() for t in ts[:6]]
    auto = torch.autograd.grad(wkv_plain(*leaves), leaves, ts[6:])
    exact = _wkv_bwd_f64(*(a.astype(np.float64) for a in (*args, do, dS)))
    for name, g, w, a, e in zip(NAMES, got, token, auto, exact):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert _rel(w.numpy(), g.numpy()) <= TOL, name
        assert _rel(a.numpy(), g.numpy()) <= TOL, name
        assert _rel(e, g.numpy()) <= TOL, name


@pytest.mark.parametrize("T,clamp", CASES)
def test_time_mix_gradient_through_the_chunk_backward_matches_reference(T, clamp, monkeypatch):
    """``jax.vjp`` of the reference's ``rwkv_time_mix`` (two heads, from a
    nonzero WKV state, cotangents on the output and on the new state)
    against the port's time mix on the card's route: ``RWKVWKV``'s forward
    the plain version writing its checkpoints, its backward
    ``wkv_bwd_chunk_plain`` fed by them.  Every parameter, x and the state
    within 1e-4 of each gradient's max; ``clamp``: w0 puts every logw at
    -1.2."""
    monkeypatch.setattr(ops, "_route", lambda t: True)
    monkeypatch.setattr(rwkv_wkv, "rwkv_wkv_cuda", wkv_plain)
    fed = []

    def bwd(*a, need, ckpt):
        fed.append(ckpt.shape)
        return wkv_bwd_chunk_plain(*a, ckpt)

    monkeypatch.setattr(rwkv_wkv_bwd, "rwkv_wkv_bwd_cuda", bwd)
    rcfg, cfg = _cfgs("rwkv6-1.6b", "float32")
    p = _with_mu(RR.init_rwkv_time_mix(jax.random.PRNGKey(T), rcfg), 5, 3)
    p = {**p, "u": jnp.asarray(np.random.default_rng(T).standard_normal(p["u"].shape).astype(np.float32))}
    if clamp:
        p = {**p, "w0": jnp.full_like(p["w0"], 3.0)}
    x, xt = _x((B, T, rcfg.d_model), "float32", T + 1)
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
    assert fed == [checkpoint_shape(B, T, H)]
    want = [_at(gp, n) for n in names] + [np.asarray(gx), np.asarray(gS)]
    for name, g, w in zip(names + ["x", "S0"], got, want):
        assert _rel(w, g.numpy()) <= TOL, name
