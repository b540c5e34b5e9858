"""The port's MoE layer against the reference's, on the CPU.

The reference draws the parameters (``repro.models.layers.init_moe``) and
``repro_torch.models.convert`` carries them across; the same activations,
made with numpy from a seed, go through both.  Tolerances, relative to
max |out|: 1e-5 in float32 (the same arithmetic, the expert products and
the router summed in another order) and aux within 1e-6; 2e-2 in bf16.
The dispatch and the combine's plain versions are held exactly against the
reference's own jnp formulas on the same ids (``src/repro/models/
layers.py:544-556`` and ``:565-566``), including ids past the capacity."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.kernels import moe_combine, moe_dispatch, ops
from repro_torch.models import layers as L
from repro_torch.models.convert import _tensor

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
B, T = 2, 24

# (arch, changes): reduced qwen3-moe as it is (E 4, k 2); E 32, k 4 at the
# default 1.25, where tokens are dropped; E 16, k 4 at 0.5; grok-like E 8, k 2
CONFIGS = [
    ("qwen3-moe-235b-a22b", {}),
    ("qwen3-moe-235b-a22b", {"num_experts": 32, "experts_per_token": 4}),
    ("qwen3-moe-235b-a22b", {"num_experts": 16, "experts_per_token": 4, "capacity_factor": 0.5}),
    ("grok-1-314b", {"num_experts": 8, "experts_per_token": 2}),
]


def _cfgs(name: str, dtype: str, **changes):
    rcfg = dataclasses.replace(ref_config(name).reduced(), dtype=dtype, **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **changes)
    return rcfg, cfg


def _params(rcfg):
    p = RL.init_moe(jax.random.PRNGKey(0), rcfg)
    return p, {n: _tensor(np.asarray(v)) for n, v in p.items()}


def _x(shape, dtype: str, seed: int = 0):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    x = x.astype(jnp.bfloat16) if dtype == "bfloat16" else x
    return x, _tensor(np.asarray(x))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _rel(want, got) -> float:
    w, g = _f32(want), _f32(got)
    return float(np.abs(w - g).max() / (np.abs(w).max() + 1e-9))


def _drops(ids: np.ndarray, E: int, C: int) -> int:
    """Assignments past their expert's capacity."""
    return int(np.maximum(np.bincount(ids.reshape(-1), minlength=E) - C, 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,changes", CONFIGS, ids=lambda c: c if isinstance(c, str) else
                         ",".join(f"{k}={v}" for k, v in c.items()) or "reduced")
def test_moe_matches_reference(name, changes, dtype):
    rcfg, cfg = _cfgs(name, dtype, **changes)
    p, pt = _params(rcfg)
    x, xt = _x((B, T, cfg.d_model), dtype)
    want, waux = RL.moe(p, x, rcfg)
    got, aux = L.moe(pt, xt, cfg)
    assert got.shape == (B, T, cfg.d_model) and got.dtype == L.cdtype(cfg)
    assert _rel(want, got) <= TOL[dtype]
    assert abs(float(waux) - float(aux)) <= AUX_TOL * max(1.0, abs(float(waux)))


def test_moe_drops_tokens_at_the_default_capacity():
    """The E 32, k 4 case at 1.25 really overflows an expert, so the test
    above holds the port to the reference's drops."""
    rcfg, cfg = _cfgs("qwen3-moe-235b-a22b", "float32", num_experts=32, experts_per_token=4)
    _, pt = _params(rcfg)
    _, xt = _x((B, T, cfg.d_model), "float32")
    _, _, ids = L.route(xt.reshape(-1, cfg.d_model), pt["router"], 4)
    C = int(B * T * 4 / 32 * cfg.capacity_factor) + 1
    assert _drops(ids.numpy(), 32, C) > 0


def test_dispatch_compute_on_an_expert_slice_matches_reference():
    """The shard body on experts 4..7 of 8: out-of-slice assignments add
    nothing, in-slice ones keep their places in the slice's order."""
    rcfg, cfg = _cfgs("grok-1-314b", "float32", num_experts=8, experts_per_token=2)
    p, pt = _params(rcfg)
    x, xt = _x((B * T, cfg.d_model), "float32", seed=3)
    sl = slice(4, 8)
    cap = int(B * T * 2 / 8 * 1.25) + 1
    want, waux = RL._moe_dispatch_compute(x, p["router"], p["wi"][sl], p["wg"][sl], p["wo"][sl], cfg=rcfg,
                                          e_offset=4, E_local=4, capacity=cap)
    got, aux = L._moe_dispatch_compute(xt, pt["router"], pt["wi"][sl], pt["wg"][sl], pt["wo"][sl], cfg=cfg,
                                       e_offset=4, E_local=4, capacity=cap)
    assert _rel(want, got) <= TOL["float32"]
    assert abs(float(waux) - float(aux)) <= AUX_TOL * abs(float(waux))
    assert np.abs(_f32(want)).max() > 0


def _ref_dispatch(xf, ids, E: int, C: int):
    """The reference's dispatch formula (layers.py:544-556) on given ids ->
    (pos per flat assignment, keep, buf)."""
    N, k = ids.shape
    flat_ids = ids.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(N), k)
    order = jnp.argsort(flat_ids)
    s_ids, s_tok = flat_ids[order], flat_tok[order]
    counts = jnp.bincount(flat_ids, length=E)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(N * k) - starts[s_ids]
    keep = pos_in_e < C
    pos_c = jnp.where(keep, pos_in_e, 0)
    buf = jnp.zeros((E, C, xf.shape[1]), xf.dtype)
    buf = buf.at[s_ids, pos_c].add(jnp.where(keep[:, None], xf[s_tok], 0))
    inv = np.argsort(np.asarray(order))
    return np.asarray(pos_in_e)[inv], np.asarray(keep)[inv], buf


def _ids(N: int, k: int, E: int, skew: float, seed: int) -> np.ndarray:
    """Each token's k distinct experts, from logits biased toward the low
    ids by ``skew`` (so the first experts overflow)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, E)) - skew * np.arange(E) / E
    return np.argsort(-logits, axis=1, kind="stable")[:, :k].astype(np.int32)


DISPATCH_CASES = [(48, 2, 4, 25, 0.0), (48, 4, 32, 8, 3.0), (64, 2, 8, 3, 6.0), (1, 2, 4, 1, 0.0), (2, 8, 128, 1, 4.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,k,E,C,skew", DISPATCH_CASES)
def test_plain_dispatch_matches_reference_formula(N, k, E, C, skew, dtype):
    ids = _ids(N, k, E, skew, seed=N + E)
    x, xt = _x((N, 16), dtype, seed=5)
    want_pos, want_keep, want_buf = _ref_dispatch(x, jnp.asarray(ids), E, C)
    buf, pos = moe_dispatch.moe_dispatch_plain(xt, torch.from_numpy(ids), E, C)
    assert pos.dtype == torch.int32 and pos.shape == (N, k)
    assert np.array_equal(pos.numpy().reshape(-1), want_pos)
    assert np.array_equal(pos.numpy().reshape(-1) < C, want_keep)
    assert buf.dtype == xt.dtype and np.array_equal(_f32(buf), _f32(want_buf))
    if C < N * k / E:
        assert not want_keep.all()  # the capacity drops some


def test_plain_dispatch_marks_other_slices():
    ids = torch.tensor([[0, 5], [-2, 1], [3, 4]], dtype=torch.int32)
    xf = torch.arange(12, dtype=torch.float32).view(3, 4)
    buf, pos = moe_dispatch.moe_dispatch_plain(xf, ids, 4, 2)
    assert pos.tolist() == [[0, -1], [-1, 0], [0, -1]]
    assert torch.equal(buf[0, 0], xf[0]) and torch.equal(buf[1, 0], xf[1]) and torch.equal(buf[3, 0], xf[2])
    assert int((buf != 0).any(-1).sum()) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,k,E,C,skew", DISPATCH_CASES)
def test_plain_combine_matches_reference_scatter_add(N, k, E, C, skew, dtype):
    """The reference's weighted gather and ``.at[s_tok].add`` (layers.py:565-566)
    on the same expert outputs, ids, capacity and weights: equal values."""
    ids = _ids(N, k, E, skew, seed=N + E + 1)
    rng = np.random.default_rng(7)
    w = rng.random((N, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    ob, obt = _x((E, C, 16), dtype, seed=9)
    flat_ids = jnp.asarray(ids.reshape(-1))
    flat_tok = jnp.repeat(jnp.arange(N), k)
    order = jnp.argsort(flat_ids)
    s_ids, s_tok, s_w = flat_ids[order], flat_tok[order], jnp.asarray(w.reshape(-1))[order]
    counts = jnp.bincount(flat_ids, length=E)
    pos_in_e = jnp.arange(N * k) - (jnp.cumsum(counts) - counts)[s_ids]
    keep = pos_in_e < C
    pos_c = jnp.where(keep, pos_in_e, 0)
    gathered = ob[s_ids, pos_c] * jnp.where(keep, s_w, 0.0)[:, None].astype(ob.dtype)
    want = jnp.zeros((N, 16), ob.dtype).at[s_tok].add(gathered)
    _, pos = moe_dispatch.moe_dispatch_plain(torch.zeros((N, 1)), torch.from_numpy(ids), E, C)
    got = moe_combine.moe_combine_plain(obt, torch.from_numpy(ids), pos, torch.from_numpy(w))
    assert got.dtype == obt.dtype and np.array_equal(_f32(got), _f32(want))


def test_router_ties_pick_the_lower_expert():
    """A zero row gives every expert the same probability, and two equal
    router columns give two experts the same one: the lower index comes
    first, as in ``jax.lax.top_k``."""
    rng = np.random.default_rng(0)
    D, E, k = 16, 8, 3
    router = rng.standard_normal((D, E)).astype(np.float32)
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 2]
    xf = rng.standard_normal((6, D)).astype(np.float32)
    xf[0] = 0.0
    xf[1] = router[:, 2] * 10.0  # experts 2, 5 and 6 tie at the top
    probs, weights, ids = L.route(torch.from_numpy(xf), torch.from_numpy(router), k)
    assert ids[0].tolist() == [0, 1, 2] and ids[1].tolist() == [2, 5, 6]
    rw, rids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1), k)
    assert np.array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(probs.gather(1, ids.long()).numpy(), np.asarray(rw), rtol=1e-6)
    np.testing.assert_allclose(weights.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_with_a_zero_row_matches_reference():
    rcfg, cfg = _cfgs("qwen3-moe-235b-a22b", "float32", num_experts=8, experts_per_token=3)
    p, pt = _params(rcfg)
    x = np.random.default_rng(2).standard_normal((1, 9, cfg.d_model)).astype(np.float32)
    x[0, 4] = 0.0
    want, waux = RL.moe(p, jnp.asarray(x), rcfg)
    got, aux = L.moe(pt, torch.from_numpy(x), cfg)
    assert _rel(want, got) <= TOL["float32"]
    assert abs(float(waux) - float(aux)) <= AUX_TOL * abs(float(waux))


def test_cpu_tensors_take_the_plain_versions_and_no_kernel():
    ops.reset_launch_counts()
    ids = torch.from_numpy(_ids(10, 2, 4, 2.0, seed=1))
    xf = torch.randn(10, 8, generator=torch.Generator().manual_seed(0))
    buf, pos = ops.moe_dispatch(xf, ids, 4, 3)
    want_buf, want_pos = moe_dispatch.moe_dispatch_plain(xf, ids, 4, 3)
    assert torch.equal(buf, want_buf) and torch.equal(pos, want_pos)
    w = torch.full((10, 2), 0.5)
    assert torch.equal(ops.moe_combine(buf, ids, pos, w), moe_combine.moe_combine_plain(buf, ids, pos, w))
    counts = ops.launch_counts()
    assert counts["moe_dispatch"] == 0 and counts["moe_combine"] == 0
    meta = torch.zeros((10, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.moe_dispatch(meta, ids.to("meta"), 4, 3)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.moe_combine(torch.zeros((4, 3, 8), device="meta"), ids.to("meta"), pos.to("meta"), w.to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    ids = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        moe_dispatch.moe_dispatch_cuda(torch.zeros((2, 8)), ids, 4, 2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        moe_combine.moe_combine_cuda(torch.zeros((4, 2, 8)), ids, ids, torch.zeros((2, 2)))
