"""The port's serving path against the reference's, on the CPU.

Generation: the reference's weights carried across (float32), the same
prompt tokens, the same greedy tokens.  Admission: the port's scalar
``AdmissionController`` and its host ``KSegmentsModel`` are float64 numpy
like the reference's, so decisions, plans and predictions must be equal
exactly, on the seeded streams of ``tests/test_serving.py``."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.core.allocation import StepAllocation as RefStepAllocation
from repro.core.ksegments import KSegmentsConfig as RefKSegmentsConfig
from repro.core.ksegments import KSegmentsModel as RefKSegmentsModel
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.serve import AdmissionController as RefAdmissionController
from repro.serve.admission import cache_bytes_per_token as ref_cache_bytes_per_token
from repro.serve.engine import greedy_generate as ref_greedy_generate
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.allocation import StepAllocation
from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import load_params
from repro_torch.models.model import init_cache, init_params
from repro_torch.serve import (AdmissionController, BatchedAdmissionController, ShardedAdmissionController,
                               ShardedScalarController, cache_bytes_per_token, make_admission_controller)
from repro_torch.serve.engine import greedy_generate

# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def test_greedy_generate_matches_reference():
    rcfg = dataclasses.replace(ref_config("llama3.2-3b").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    model = load_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(ref_greedy_generate(params, rcfg, jnp.asarray(tokens), steps=5))
    got = greedy_generate(model, cfg, torch.from_numpy(tokens), steps=5, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    again = greedy_generate(model, cfg, torch.from_numpy(tokens), steps=5, device="cpu")
    assert torch.equal(got, again)  # greedy decode is deterministic


def test_steps_refuse_a_model_on_another_device():
    cfg = get_config("llama3.2-3b").reduced()
    model = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="the model is on"):
        greedy_generate(model, cfg, torch.zeros((1, 4), dtype=torch.int32), steps=2, device="meta")


def test_launcher_serves_every_request_on_cpu():
    logs = []
    out = launch_serve.main(["--device", "cpu", "--requests", "6", "--decode-steps", "4"])
    assert out["done"] == 6 and out["rejected"] == 0
    vocab = get_config("llama3.2-3b").reduced().vocab_size
    assert sum(o.shape[0] for o in out["outputs"]) == 6
    assert all(o.shape[1] == 4 and int(o.min()) >= 0 and int(o.max()) < vocab for o in out["outputs"])
    # the same loop with a chosen model and logger
    cfg = get_config("llama3.2-3b").reduced()
    ctl = AdmissionController(hbm_budget_mib=512.0, k=4, interval_s=1.0)
    res = launch_serve.serve_requests(cfg, init_params(cfg, device="cpu"), ctl, requests=5, decode_steps=3,
                                      bytes_per_token_mib=0.1, device="cpu", log=logs.append)
    assert res["done"] == 5 and res["waves"] == 2 and len(logs) == 3 and not ctl.active
    assert ctl.model.n_observations == 5


def test_launcher_serves_an_moe_model_on_cpu():
    """The reduced qwen3-moe through the launcher: its layers' routed
    experts take the plain dispatch and combine on the CPU."""
    out = launch_serve.main(["--arch", "qwen3-moe-235b-a22b", "--device", "cpu", "--requests", "4"])
    vocab = get_config("qwen3-moe-235b-a22b").reduced().vocab_size
    assert out["done"] == 4 and sum(o.shape[0] for o in out["outputs"]) == 4
    assert all(o.shape[1] == 16 and int(o.min()) >= 0 and int(o.max()) < vocab for o in out["outputs"])


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_launcher_serves_a_recurrent_model_on_cpu(name):
    """The reduced rwkv6 and recurrentgemma through the launcher: their
    recurrences take the plain versions on the CPU; the decode steps carry
    the recurrent state in the cache."""
    out = launch_serve.main(["--arch", name, "--device", "cpu", "--requests", "5", "--decode-steps", "6"])
    vocab = get_config(name).reduced().vocab_size
    assert out["done"] == 5 and out["rejected"] == 0 and sum(o.shape[0] for o in out["outputs"]) == 5
    assert all(o.shape[1] == 6 and int(o.min()) >= 0 and int(o.max()) < vocab for o in out["outputs"])


def test_greedy_generate_of_a_recurrent_model_matches_reference():
    """The reduced recurrentgemma (rglru and local layers) in float32: the
    reference's greedy tokens."""
    rcfg = dataclasses.replace(ref_config("recurrentgemma-2b").reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(), dtype="float32")
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    model = load_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(ref_greedy_generate(params, rcfg, jnp.asarray(tokens), steps=5))
    got = greedy_generate(model, cfg, torch.from_numpy(tokens), steps=5, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_admission_engine_registry():
    assert isinstance(make_admission_controller("scalar", hbm_budget_mib=100.0), AdmissionController)
    batched = make_admission_controller("batched", hbm_budget_mib=100.0, device="cpu")
    assert isinstance(batched, BatchedAdmissionController) and batched.device_min_batch == 32
    sharded = make_admission_controller("sharded-scalar", hbm_budget_mib=100.0, n_shards=2)
    assert isinstance(sharded, ShardedScalarController) and sharded.shard_budget == 50.0
    carried = make_admission_controller("sharded", hbm_budget_mib=100.0, n_shards=2, device="cpu")
    assert isinstance(carried, ShardedAdmissionController) and carried.shard_budget == 50.0
    assert carried.try_admit("r0", 100, 0.0) is not None and "r0" in carried.active  # the 5% placeholder fits
    with pytest.raises(ValueError, match="unknown admission engine"):
        make_admission_controller("nope", hbm_budget_mib=100.0)


# ---------------------------------------------------------------------------
# admission: the reference's streams, both controllers in lockstep
# ---------------------------------------------------------------------------


def _growth_series(prompt_len, decode_steps):
    return (prompt_len * 0.08 + 8.0 * np.arange(decode_steps)).astype(np.float32)


def _fake_request_series(prompt_len, decode_steps, bpt_mib):
    base = prompt_len * bpt_mib
    return np.asarray([base + i * bpt_mib for i in range(decode_steps)], np.float32)


def _same_plan(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a.request_id == b.request_id and a.admitted_at == b.admitted_at
            and np.array_equal(a.alloc.boundaries, b.alloc.boundaries)
            and np.array_equal(a.alloc.values, b.alloc.values))


def _pair(budget, k, interval):
    return RefAdmissionController(budget, k=k, interval_s=interval), AdmissionController(budget, k=k,
                                                                                         interval_s=interval)


def test_admission_learns_and_packs_like_the_reference():
    rng = np.random.default_rng(0)
    ref, ctl = _pair(10_000.0, 4, 1.0)
    for _ in range(50):
        plen = int(rng.integers(100, 2000))
        steps = int(60 + plen * 0.05 + rng.normal(0, 2))
        for c in (ref, ctl):
            c.observe(plen, _growth_series(plen, steps))
    a, b = ref.model.predict(1000.0), ctl.model.predict(1000.0)
    assert np.array_equal(a.boundaries, b.boundaries) and np.array_equal(a.values, b.values)
    dt = float(a.boundaries[-1]) / 20.0
    now, admitted = 0.0, 0
    for i in range(200):
        for c in (ref, ctl):
            for rid, plan in list(c.active.items()):
                if now - plan.admitted_at > float(plan.alloc.boundaries[-1]):
                    c.release(rid)
        pa, pb = ref.try_admit(f"r{i}", 1000, now), ctl.try_admit(f"r{i}", 1000, now)
        assert _same_plan(pa, pb), i
        admitted += pa is not None
        assert sorted(ref.active) == sorted(ctl.active)
        now += dt
    assert 0 < admitted < 200  # the budget binds, and the stream is not all rejects


class _FixedModel:
    def __init__(self, boundaries, values, alloc_cls):
        self.alloc = alloc_cls(np.asarray(boundaries), np.asarray(values))
        self.n_observations = 1

    def predict(self, _prompt_len):
        return self.alloc


@pytest.mark.parametrize("now", [0.0, 1.0e12])  # 1e12: float64 resolution coarser than any epsilon
def test_switch_point_probes_like_the_reference(now):
    ref, ctl = _pair(1000.0, 2, 1.0)
    got = []
    for c, alloc_cls in ((ref, RefStepAllocation), (ctl, StepAllocation)):
        c.model = _FixedModel([10.0, 30.0], [100.0, 900.0], alloc_cls)
        leader = c.try_admit("leader", 100, now)
        c.model = _FixedModel([5.0, 40.0], [50.0, 200.0], alloc_cls)
        blocked = c.try_admit("newcomer", 100, now)
        c.release("leader")
        after = c.try_admit("newcomer", 100, now)
        got.append((leader is not None, blocked is None, after is not None))
    assert got[0] == got[1] == (True, True, True)


def test_release_at_final_boundary_like_the_reference():
    ref, ctl = _pair(10_000.0, 2, 1.0)
    for c, alloc_cls in ((ref, RefStepAllocation), (ctl, StepAllocation)):
        c.model = _FixedModel([10.0, 20.0], [100.0, 500.0], alloc_cls)
        assert c.try_admit("r0", 100, 0.0) is not None
    probes = (0.0, 5.0, 10.0, 10.0 + 1e-9, 20.0, 20.0 + 1e-6, 25.0)
    a, b = ref._combined_demand(probes), ctl._combined_demand(probes)
    assert np.array_equal(a, b)
    assert b[4] == 500.0 and b[5] == 0.0


def test_reservation_wastage_like_the_reference():
    ref, ctl = _pair(50_000.0, 4, 1.0)
    rng = np.random.default_rng(1)
    for _ in range(40):
        plen = int(rng.integers(100, 2000))
        series = _fake_request_series(plen, 60 + int(plen * 0.05), 0.8)
        for c in (ref, ctl):
            c.observe(plen, series)
    plans = {id(ref): [], id(ctl): []}
    for i in range(10):
        plen = int(rng.integers(200, 1800))
        series = _fake_request_series(plen, 60 + int(plen * 0.05), 0.8)
        pa, pb = ref.try_admit(f"q{i}", plen, 0.0), ctl.try_admit(f"q{i}", plen, 0.0)
        assert _same_plan(pa, pb) and pb is not None
        plans[id(ref)].append((pa, series, 1.0))
        plans[id(ctl)].append((pb, series, 1.0))
    wa, wb = ref.reservation_wastage(plans[id(ref)]), ctl.reservation_wastage(plans[id(ctl)])
    assert wa == wb
    assert wb["segmentwise_gib_s"] < wb["peak_reservation_gib_s"]


# ---------------------------------------------------------------------------
# the host k-Segments model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("error_mode,window", [("insample", None), ("insample", 8), ("progressive", None)])
@pytest.mark.parametrize("offset_mode", ["absolute", "relative"])
def test_ksegments_model_predicts_like_the_reference(error_mode, window, offset_mode):
    kw = dict(k=4, interval_s=2.0, floor_mib=50.0, error_mode=error_mode, insample_window=window,
              offset_mode=offset_mode)
    ref, port = RefKSegmentsModel(RefKSegmentsConfig(**kw)), KSegmentsModel(KSegmentsConfig(**kw))
    rng = np.random.default_rng(5)
    probes = np.asarray([3.0e9, 7.5e9, 1.2e10])
    for n in range(40):
        x = float(rng.uniform(1e9, 2e10))
        steps = int(20 + x / 1e9 + rng.integers(0, 8))
        series = x / 4e7 * (1 + np.arange(steps) / steps) + rng.normal(0, 30.0, steps)
        for m in (ref, port):
            m.observe(x, series)
        for x_new in probes:
            a, b = ref.predict(x_new), port.predict(x_new)
            assert np.array_equal(a.boundaries, b.boundaries) and np.array_equal(a.values, b.values), n
        ba, va = ref.predict_batch(probes)
        bb, vb = port.predict_batch(probes)
        assert np.array_equal(ba, bb) and np.array_equal(va, vb)
    sa, sb = ref.state(), port.state()
    assert sa.keys() == sb.keys() and all(np.array_equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_bytes_per_token(name):
    """Equal to the reference's for every config, and to the k and v bytes
    of the port's own cache for every config (the frontends' too); a recurrent
    layer's state (no bytes a token) takes the bytes of the reference's
    state of that name."""
    cfg = ARCHS[name]
    assert cache_bytes_per_token(cfg) == ref_cache_bytes_per_token(REF_ARCHS[name])
    batch, max_len = 1, 7
    cache = init_cache(cfg, batch, max_len, device="cpu")
    kv = sum(c[n].numel() * c[n].element_size() for c in cache if "k" in c for n in ("k", "v"))
    assert kv == batch * max_len * cache_bytes_per_token(cfg)
    ref = jax.eval_shape(lambda: ref_init_cache(REF_ARCHS[name], batch, max_len))
    ref_bytes = collections.Counter()
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        ref_bytes[path[-1].key] += leaf.size * leaf.dtype.itemsize
    got_bytes = collections.Counter()
    for c in cache:
        for n, t in c.items():
            got_bytes[n] += t.numel() * t.element_size()
    states = {"shift", "wkv", "cm_shift", "h", "conv"}
    assert {n: b for n, b in got_bytes.items() if n in states} == {n: b for n, b in ref_bytes.items() if n in states}
    assert (set(got_bytes) & states) == ({"shift", "wkv", "cm_shift"} if "rwkv" in cfg.layer_kinds else
                                         {"h", "conv"} if "rglru" in cfg.layer_kinds else set())
