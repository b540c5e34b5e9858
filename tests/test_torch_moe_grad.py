"""The MoE layer's gradients in the port against the reference's, on the
CPU.

The plain backward functions (``moe_dispatch_bwd_plain``,
``moe_combine_bwd_plain``) against autograd through the plain forwards:
d_out_buf and dxf exactly (the same adds in the same order, each rounded to
the dtype), dw within 1e-6 of max |dw| in float32 and exactly in bf16, a
dropped assignment's dw exactly 0.  The layer's vjp against ``jax.vjp`` of
``repro.models.layers.moe`` and of ``_moe_dispatch_compute`` on an expert
slice: float32 within 1e-5 of each leaf's max |g| (the same arithmetic
summed in other orders), at capacity 8.0 and at 1.25 where tokens drop.
The two autograd functions of the card's path (``MoEDispatch``,
``MoECombine``) run here with their kernel calls replaced by the plain
versions, against autograd through the plain forwards."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.kernels import moe_combine, moe_combine_bwd, moe_dispatch, ops
from repro_torch.models import layers as L
from repro_torch.models.convert import _tensor

GRAD_TOL = 1e-5  # float32, of each leaf's max |g|
DW_TOL = 1e-6  # float32 dw of the plain backward against autograd, of max |dw|
B, T = 2, 24

# (N, k, E, C, skew, offset, last_dropped): test_torch_moe's grid (drops,
# k 8 at decode's C 1), ids of other slices (offset: ids in [-offset, E +
# offset)), and the last token's assignments all dropped
GRAD_CASES = [
    (48, 2, 4, 25, 0.0, 0, False),
    (48, 4, 32, 8, 3.0, 0, False),
    (64, 2, 8, 3, 6.0, 0, False),
    (1, 2, 4, 1, 0.0, 0, False),
    (2, 8, 128, 1, 4.0, 0, False),
    (60, 3, 6, 12, 3.0, 2, False),
    (40, 4, 8, 10, 2.0, 0, True),
    (30, 8, 16, 6, 3.0, 0, True),
]


def _ids(N: int, k: int, E: int, skew: float, offset: int, last_dropped: bool, seed: int) -> torch.Tensor:
    """Each token's k distinct experts from logits biased toward the low ids
    (the router's top-k); ids of another slice lie outside [0, E).  With
    ``last_dropped``, the last token takes the k experts most loaded by the
    others, which the capacity has filled by then."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, E + 2 * offset)) - skew * np.arange(E + 2 * offset) / E
    ids = np.argsort(-logits, axis=1, kind="stable")[:, :k] - offset
    if last_dropped:
        counts = np.bincount(ids[:-1].reshape(-1), minlength=E)
        ids[-1] = np.argsort(-counts, kind="stable")[:k]
    return torch.from_numpy(ids.astype(np.int32))


def _randn(shape, dtype, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backwards_equal_autograd_through_plain_forwards(case, dtype):
    N, k, E, C, skew, offset, last_dropped = case
    D = 16
    ids = _ids(N, k, E, skew, offset, last_dropped, seed=N + E)
    xf = _randn((N, D), dtype, 1).requires_grad_()
    buf, pos = moe_dispatch.moe_dispatch_plain(xf, ids, E, C)
    kept = (pos >= 0) & (pos < C)
    if skew > 0:
        assert not kept[(ids >= 0) & (ids < E)].all()  # the capacity drops
    if offset:
        assert (ids < 0).any() and (ids >= E).any() and not pos[(ids < 0) | (ids >= E)].ge(0).any()
    if last_dropped:
        assert not kept[-1].any()
    dbuf = _randn(buf.shape, dtype, 2)
    (dxf,) = torch.autograd.grad(buf, xf, dbuf)
    want = moe_dispatch.moe_dispatch_bwd_plain(dbuf, ids, pos)
    assert want.dtype == dtype and torch.equal(_bits(want), _bits(dxf))
    if last_dropped:
        assert not want[-1].any()

    out_buf = _randn((E, C, D), dtype, 3).requires_grad_()
    w = torch.from_numpy(np.random.default_rng(4).random((N, k)).astype(np.float32))
    w = (w / w.sum(-1, keepdim=True)).requires_grad_()
    out = moe_combine.moe_combine_plain(out_buf, ids, pos, w)
    dout = _randn(out.shape, dtype, 5)
    d_buf, dw = torch.autograd.grad(out, (out_buf, w), dout)
    got_buf, got_w = moe_combine_bwd.moe_combine_bwd_plain(dout, out_buf.detach(), ids, pos, w.detach())
    assert got_buf.dtype == dtype and torch.equal(_bits(got_buf), _bits(d_buf))
    assert got_w.dtype == torch.float32 and (got_w[~kept] == 0).all() and (dw[~kept] == 0).all()
    tol = DW_TOL * dw.abs().max().item() if dtype == torch.float32 else 0.0
    assert (got_w - dw).abs().max().item() <= tol
    # the empty slots of every expert get zero, the kept ones a weighted row
    assert int((got_buf != 0).any(-1).sum()) == int(kept.sum())
    only_w = moe_combine_bwd.moe_combine_bwd_plain(dout, out_buf.detach(), ids, pos, w.detach(), need_buf=False)
    assert only_w[0] is None and torch.equal(only_w[1], got_w)


def _cfgs(name: str, **changes):
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype="float32", **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", **changes)
    return rcfg, cfg


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


def _vjp_case(rcfg, cfg, fn_ref, fn_port, x: np.ndarray, names, slices=None):
    """jax.vjp of ``fn_ref(p, x) -> (out, aux)`` against autograd of the
    port's, with the same cotangent on out and 0.01 on aux; returns the
    relative distances of dx and of each leaf in ``names``."""
    p = RL.init_moe(jax.random.PRNGKey(0), rcfg)
    if slices is not None:
        p = {n: (v[slices] if n != "router" else v) for n, v in p.items()}
    pt = {n: _tensor(np.asarray(v)).requires_grad_() for n, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = fn_port(pt, xt)
    cot = np.random.default_rng(11).standard_normal(out.shape).astype(np.float32)
    (rout, raux), vjp = jax.vjp(fn_ref, p, jnp.asarray(x))
    rgp, rgx = vjp((jnp.asarray(cot), jnp.float32(0.01)))
    grads = torch.autograd.grad((out, aux), [xt] + [pt[n] for n in names],
                                (torch.from_numpy(cot), torch.tensor(0.01)))
    assert _rel(out, rout) <= GRAD_TOL and abs(aux.item() - float(raux)) <= 1e-6 * abs(float(raux))
    return {"dx": _rel(grads[0], rgx), **{n: _rel(g, rgp[n]) for n, g in zip(names, grads[1:])}}


@pytest.mark.parametrize("capacity", [8.0, 1.25])
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_moe_layer_vjp_matches_reference(name, capacity):
    changes = dict(num_experts=32, experts_per_token=4) if name.startswith("qwen3") else dict(num_experts=8,
                                                                                             experts_per_token=2)
    rcfg, cfg = _cfgs(name, capacity_factor=capacity, **changes)
    # one direction shared by every token skews the routing, so that 1.25 drops
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, T, cfg.d_model)) + rng.standard_normal(cfg.d_model)).astype(np.float32)
    N, E, k = B * T, cfg.num_experts, cfg.experts_per_token
    _, _, ids = L.route(torch.from_numpy(x).reshape(N, -1), _tensor(np.asarray(
        RL.init_moe(jax.random.PRNGKey(0), rcfg)["router"])), k)
    drops = int(np.maximum(np.bincount(ids.numpy().reshape(-1), minlength=E) - int(N * k / E * capacity) - 1,
                           0).sum())
    assert (drops > 0) == (capacity == 1.25)
    dist = _vjp_case(rcfg, cfg, lambda p, xx: RL.moe(p, xx, rcfg), lambda p, xx: L.moe(p, xx, cfg), x,
                     ("router", "wi", "wg", "wo"))
    assert max(dist.values()) <= GRAD_TOL, dist


@pytest.mark.parametrize("capacity", [8.0, 1.25])
def test_dispatch_compute_vjp_on_an_expert_slice_matches_reference(capacity):
    """The shard body on experts 4..7 of 8: no gradient reaches the slice
    from another slice's assignments."""
    rcfg, cfg = _cfgs("grok-1-314b", num_experts=8, experts_per_token=2)
    N = B * T
    cap = int(N * 2 / 8 * capacity) + 1
    sl = slice(4, 8)
    rng = np.random.default_rng(5)  # a shared direction skews the routing, as above
    x = (rng.standard_normal((N, cfg.d_model)) + rng.standard_normal(cfg.d_model)).astype(np.float32)
    router = _tensor(np.asarray(RL.init_moe(jax.random.PRNGKey(0), rcfg)["router"]))
    local = L.route(torch.from_numpy(x), router, 2)[2].numpy() - 4
    drops = int(np.maximum(np.bincount(local[local >= 0], minlength=4)[:4] - cap, 0).sum())
    assert (drops > 0) == (capacity == 1.25) and (local < 0).any()
    kw = dict(e_offset=4, E_local=4, capacity=cap)
    dist = _vjp_case(rcfg, cfg,
                     lambda p, xx: RL._moe_dispatch_compute(xx, p["router"], p["wi"], p["wg"], p["wo"], cfg=rcfg, **kw),
                     lambda p, xx: L._moe_dispatch_compute(xx, p["router"], p["wi"], p["wg"], p["wo"], cfg=cfg, **kw),
                     x, ("router", "wi", "wg", "wo"), slices=sl)
    assert max(dist.values()) <= GRAD_TOL, dist


@pytest.fixture
def plain_kernels(monkeypatch):
    """The card's route on CPU tensors: ``ops._route`` true, each kernel
    call its plain version, the calls counted with the arguments asked."""
    calls = {"dispatch": 0, "combine": 0, "combine_bwd": []}

    def dispatch(xf, ids, E, C):
        calls["dispatch"] += 1
        return moe_dispatch.moe_dispatch_plain(xf, ids, E, C)

    def combine(out_buf, ids, pos, w):
        calls["combine"] += 1
        return moe_combine.moe_combine_plain(out_buf, ids, pos, w)

    def combine_bwd(dout, out_buf, ids, pos, w, need_buf=True, need_w=True):
        calls["combine_bwd"].append((need_buf, need_w))
        return moe_combine_bwd.moe_combine_bwd_plain(dout, out_buf, ids, pos, w, need_buf, need_w)

    monkeypatch.setattr(ops, "_route", lambda t: True)
    monkeypatch.setattr(moe_dispatch, "moe_dispatch_cuda", dispatch)
    monkeypatch.setattr(moe_combine, "moe_combine_cuda", combine)
    monkeypatch.setattr(moe_combine_bwd, "moe_combine_bwd_cuda", combine_bwd)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_equal_autograd_through_plain_forwards(plain_kernels, dtype):
    """``MoEDispatch``: pos not differentiable, dxf one combine call with
    unit weights; ``MoECombine``: what needs_input_grad asks, dw 0 where
    dropped.  Both equal autograd through the plain forwards."""
    N, k, E, C, D = 40, 4, 8, 10, 16
    ids = _ids(N, k, E, 2.0, 0, True, seed=7)
    x = _randn((N, D), dtype, 1)
    xf = x.clone().requires_grad_()
    buf, pos = ops.moe_dispatch(xf, ids, E, C)
    assert plain_kernels["dispatch"] == 1 and buf.grad_fn is not None and not pos.requires_grad
    dbuf = _randn(buf.shape, dtype, 2)
    (dxf,) = torch.autograd.grad(buf, xf, dbuf)
    assert plain_kernels["combine"] == 1  # the dispatch's backward
    xp = x.clone().requires_grad_()
    want_buf, want_pos = moe_dispatch.moe_dispatch_plain(xp, ids, E, C)
    (want,) = torch.autograd.grad(want_buf, xp, dbuf)
    assert torch.equal(pos, want_pos) and torch.equal(_bits(dxf), _bits(want))

    ob = _randn((E, C, D), dtype, 3)
    w0 = torch.from_numpy(np.random.default_rng(4).random((N, k)).astype(np.float32))
    dout = _randn((N, D), dtype, 5)
    kept = (pos >= 0) & (pos < C)
    for need in ((True, True), (False, True), (True, False)):
        leaves = [ob.clone().requires_grad_(need[0]), w0.clone().requires_grad_(need[1])]
        out = ops.moe_combine(leaves[0], ids, pos, leaves[1])
        grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dout)
        assert plain_kernels["combine_bwd"][-1] == need
        plain = [ob.clone().requires_grad_(need[0]), w0.clone().requires_grad_(need[1])]
        want = torch.autograd.grad(moe_combine.moe_combine_plain(plain[0], ids, pos, plain[1]),
                                   [t for t in plain if t.requires_grad], dout)
        assert torch.equal(_bits(out.detach()), _bits(moe_combine.moe_combine_plain(ob, ids, pos, w0)))
        for g, wg in zip(grads, want):
            if g.dtype == dtype:  # d_out_buf
                assert torch.equal(_bits(g), _bits(wg))
            else:  # dw
                assert (g[~kept] == 0).all() and (g - wg).abs().max().item() <= DW_TOL * wg.abs().max().item()
    assert plain_kernels["combine"] == 4 and len(plain_kernels["combine_bwd"]) == 3
    with torch.no_grad():  # nothing recorded: the kernel alone
        assert ops.moe_combine(ob.requires_grad_(), ids, pos, w0).grad_fn is None
    assert len(plain_kernels["combine_bwd"]) == 3


def test_moe_layer_through_the_autograd_functions_equals_the_plain_path(plain_kernels, monkeypatch):
    """The whole layer on the card's route (the functions, their kernel
    calls the plain versions) against the plain path: dx and the four
    leaves equal; one dispatch, one combine and one combine_bwd a
    backward, and a combine for the dispatch's."""
    _, cfg = _cfgs("qwen3-moe-235b-a22b", num_experts=32, experts_per_token=4)
    rcfg = dataclasses.replace(ref_config("qwen3-moe-235b-a22b").reduced(), dtype="float32", num_experts=32,
                               experts_per_token=4)
    p = {n: _tensor(np.asarray(v)) for n, v in RL.init_moe(jax.random.PRNGKey(0), rcfg).items()}
    x = _randn((B, T, cfg.d_model), torch.float32, 6)
    cot = _randn((B, T, cfg.d_model), torch.float32, 7)
    grads = {}
    for route in ("card", "plain"):
        leaves = {n: v.clone().requires_grad_() for n, v in p.items()}
        xx = x.clone().requires_grad_()
        if route == "plain":
            monkeypatch.setattr(ops, "_route", lambda t: False)
        out, aux = L.moe(leaves, xx, cfg)
        grads[route] = torch.autograd.grad((out, aux), [xx, *leaves.values()], (cot, torch.tensor(0.01)))
    assert plain_kernels["dispatch"] == 1 and plain_kernels["combine"] == 2 and len(plain_kernels["combine_bwd"]) == 1
    for a, b in zip(*grads.values()):
        assert torch.equal(a, b)
