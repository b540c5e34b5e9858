"""The port's engine pieces against the reference engine (``repro.sim.jax_sim``)
on the same seeded inputs: regression banks, the running sums, the prefix
programs (Witt, PPM, Sizey), KS+'s relative prediction, the insample window
offsets (absolute and relative), the carry round trip, and
``simulate_task_methods`` for all nine methods in both error modes.

Tolerances: retry counts exact; predicted bounds and values rtol 1e-6,
because XLA fuses f32 multiply-adds (one rounding) where PyTorch rounds
each op; wastage rtol 1e-5 with atol 1e-4 GiB*s, because the f32 sums over a
series also run in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regression as ref_reg
from repro.core.ksegments import KSegmentsConfig as RefKConfig
from repro.core.ksegments import KSegmentsModel
from repro.sim import jax_sim
from repro_torch.core import regression
from repro_torch.core.ksegments import carry_from_numpy, carry_to_numpy
from repro_torch.kernels import ops
from repro_torch.sim import torch_sim, traces

PRED_TOL = dict(rtol=1e-6, atol=1e-6)
WASTE_TOL = dict(rtol=1e-5, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _observed_stats(seed: int, n_banks: int, n_obs: int) -> np.ndarray:
    """Regression banks folded from seeded observations (shifted inputs)."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((n_obs, n_banks)) * 3e9).astype(np.float32)
    y = (rng.random((n_obs, n_banks)) * 5e3 + 3e-7 * u).astype(np.float32)
    stats = np.zeros((n_banks, 5), np.float32)
    for i in range(n_obs):
        stats = np.asarray(ref_reg.update_stats(jnp.asarray(stats), u[i], y[i]))
    return stats


def test_regression_matches_reference():
    stats = _observed_stats(0, 64, 7)
    got_s = regression.update_stats(_t(stats), _t(stats[:, 1]), _t(stats[:, 3]))
    want_s = ref_reg.update_stats(jnp.asarray(stats), stats[:, 1], stats[:, 3])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))  # elementwise, no fused op
    for got, want in zip(regression.fit(_t(stats)), ref_reg.fit(jnp.asarray(stats))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRED_TOL)
    x = np.linspace(-5e9, 5e9, 64).astype(np.float32)
    np.testing.assert_allclose(
        regression.predict(_t(stats), _t(x)).numpy(), np.asarray(ref_reg.predict(jnp.asarray(stats), x)), rtol=1e-5
    )


def test_merge_stats_matches_reference():
    a, b = _observed_stats(3, 16, 5), _observed_stats(4, 16, 9)
    got = regression.merge_stats(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_reg.merge_stats(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(regression.merge_stats(_t(a), regression.empty_stats(16)).numpy(), a)


def test_regression_degenerate_fits():
    """Empty banks, one observation and all-equal inputs fall back to the mean model."""
    np.testing.assert_array_equal(regression.empty_stats(3).numpy(), np.asarray(ref_reg.empty_stats(3)))
    banks = regression.empty_stats(3).numpy()
    banks[1] = [1, 0, 0, 42.0, 0]
    banks[2] = [3, 0, 0, 30.0, 0]  # three observations at u = 0
    intercept, slope = regression.fit(_t(banks))
    np.testing.assert_array_equal(intercept.numpy(), [0.0, 42.0, 10.0])
    np.testing.assert_array_equal(slope.numpy(), [0.0, 0.0, 0.0])
    for got, want in zip((intercept, slope), ref_reg.fit(jnp.asarray(banks))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [7, 16, 33, 300])
def test_cumsum_adds_in_the_reference_order(n):
    """``ops.prefix_sum(., 16)`` equals jnp.cumsum bit for bit; a block as
    long as the axis is the scan's sequential fold."""
    a = (np.random.default_rng(n).standard_normal((3, n)) * 1e3).astype(np.float32)
    np.testing.assert_array_equal(torch_sim._xla_cumsum(_t(a)).numpy(), np.asarray(jnp.cumsum(jnp.asarray(a), axis=1)))
    seq = np.zeros_like(a)
    acc = np.zeros(3, np.float32)
    for i in range(n):
        acc = acc + a[:, i]
        seq[:, i] = acc
    np.testing.assert_array_equal(ops.prefix_sum(_t(a), -1, block=n).numpy(), seq)
    # along a middle axis, as the predict phase folds (lanes, executions, stats)
    np.testing.assert_array_equal(ops.prefix_sum(_t(a).T[None], 1, block=n)[0].T.numpy(), seq)


# the predict phase's scan calls at L = 2 lanes of B executions, k = 2:
# (shape, axis, sequential), as chip_smoke.scan_shapes lists them at full size
PREDICT_SCAN_CALLS = {
    "bank": (lambda B: (2, B, 5), 1, False),  # torch_sim._prefix_bank
    "ppm": (lambda B: (2, B, B), 2, False),  # PPM's C and S
    "contrib": (lambda B: (2, B, B), 1, False),  # PPM-improved's contrib
    "sizey": (lambda B: (2, 2, 2, B), 3, False),  # Sizey's scores
    "fold": (lambda B: (2, B, 5 * (1 + 2)), 1, True),  # predict_lanes: the banks' fold
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B", [17, 40])
@pytest.mark.parametrize("call", list(PREDICT_SCAN_CALLS))
def test_cumsum_adds_in_the_reference_order_at_predict_calls(call, B, dtype):
    """``ops.prefix_sum`` on the CPU (the plain version the card's kernel is
    held to) at each predict-phase call's shape and axis, a -0.0 first:
    XLA's order bit for bit against jnp.cumsum, the fold against a
    ``lax.scan`` carry."""
    make, dim, sequential = PREDICT_SCAN_CALLS[call]
    shape = make(B)
    rng = np.random.default_rng(B + len(call))
    a = rng.standard_normal(shape) * 1e3
    a[rng.random(shape) < 0.05] = -0.0
    a[(slice(None),) * dim + (0,)] = -0.0
    a = a.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        x = jnp.asarray(a)
        if sequential:
            step = lambda c, xi: (c + xi, c + xi)  # noqa: E731
            _, ys = jax.lax.scan(step, jnp.zeros(x.shape[:dim] + x.shape[dim + 1:], x.dtype), jnp.moveaxis(x, dim, 0))
            want = np.asarray(jnp.moveaxis(ys, 0, dim))
        else:
            want = np.asarray(jnp.cumsum(x, axis=dim))
    got = ops.prefix_sum(_t(a), dim, block=shape[dim] if sequential else 16).numpy()
    bits = np.int64 if dtype == np.float64 else np.int32
    assert want.dtype == a.dtype
    np.testing.assert_array_equal(got.view(bits), want.view(bits))
    assert not np.signbit(np.take(got, 0, axis=dim)).any()  # the leading -0.0 became +0.0


def _prefix_inputs(seed: int, B: int):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(21.0, 0.5, size=B)
    u = (x.astype(np.float32) - np.float32(x[0])).astype(np.float32)
    gpeak = (rng.random(B) * 3000.0 + 200.0).astype(np.float32)
    return u, gpeak


@pytest.mark.parametrize("B", [1, 5, 40])
def test_witt_prefix_values_match_reference(B):
    u, gpeak = _prefix_inputs(B, B)
    want = jax_sim._witt_prefix_values(jnp.asarray(u), jnp.asarray(gpeak), 100.0)
    got = torch_sim._witt_prefix_values(_t(u)[None], _t(gpeak)[None], 100.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), **PRED_TOL)


@pytest.mark.parametrize("B", [1, 6, 50])
def test_ppm_prefix_values_match_reference_with_tied_peaks(B):
    rng = np.random.default_rng(B)
    gpeak = rng.choice(np.float32([120.0, 800.0, 800.0, 2500.0, 640.5]), size=B).astype(np.float32)
    gpeak[B // 2 :] = np.float32(800.0)  # many ties: the stable sort decides candidate order
    rt = rng.integers(1, 400, size=B).astype(np.float32)
    want = jax_sim._ppm_prefix_values(jnp.asarray(gpeak), jnp.asarray(rt), 128 * 1024.0, 100.0)
    got = torch_sim._ppm_prefix_values(_t(gpeak)[None], _t(rt)[None], 128 * 1024.0, 100.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), **PRED_TOL)


def _sizey_inputs(seed: int, B: int, tied: bool):
    u, gpeak = _prefix_inputs(seed, B)
    if tied:  # ties in the peaks: the stable sort and the first hit decide
        rng = np.random.default_rng(seed + 1)
        gpeak = rng.choice(np.float32([120.0, 800.0, 2500.0, 640.5]), size=B).astype(np.float32)
        gpeak[B // 2 :] = np.float32(800.0)
    return u, gpeak


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("B", [1, 2, 3, 7, 40, 130])
def test_sizey_prefix_values_match_reference(B, tied):
    u, gpeak = _sizey_inputs(B, B, tied)
    want = jax_sim._sizey_prefix_values(jnp.asarray(u), jnp.asarray(gpeak), 100.0)
    got = torch_sim._sizey_prefix_values(_t(u)[None], _t(gpeak)[None], 100.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **PRED_TOL)
    # batched over lanes, sharing Witt's prefix bank, each lane as alone
    u2, g2 = _sizey_inputs(B + 100, B, not tied)
    U, G = _t(np.stack([u, u2])), _t(np.stack([gpeak, g2]))
    both = torch_sim._sizey_prefix_values(U, G, 100.0, torch_sim._prefix_bank(U, G))
    np.testing.assert_array_equal(both[0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(both[1].numpy(), torch_sim._sizey_prefix_values(_t(u2)[None], _t(g2)[None], 100.0)[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_rel_matches_reference(seed):
    k = 4
    rng = np.random.default_rng(seed)
    rt_stats = _observed_stats(10 + seed, 1, 6)[0]
    seg_stats = _observed_stats(20 + seed, k, 6)
    rt_rel = np.float32(rng.standard_normal() * 0.3)
    seg_rel = (rng.standard_normal(k) * 0.3).astype(np.float32)
    for u in (rng.standard_normal(5) * 3e9).astype(np.float32):
        for k_eff in (1, 3, 4):
            want = jax_sim._predict_rel(
                jnp.asarray(rt_stats), jnp.asarray(rt_rel), jnp.asarray(seg_stats), jnp.asarray(seg_rel),
                jnp.asarray(u), k, jnp.asarray(k_eff), 2.0, 100.0,
            )
            got = torch_sim._predict_rel(_t(rt_stats), _t(rt_rel), _t(seg_stats), _t(seg_rel), torch.tensor(u), k,
                                         k_eff, 2.0, 100.0)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **PRED_TOL)


@pytest.mark.parametrize("n_obs", [0, 3, 8, 20])
def test_window_offsets_match_reference(n_obs):
    W, k = 8, 4
    rng = np.random.default_rng(n_obs)
    rt_stats = _observed_stats(1, 1, 9)[0]
    seg_stats = _observed_stats(2, k, 9)
    hist = (
        (rng.standard_normal(W) * 1e9).astype(np.float32),
        (rng.random(W) * 600.0).astype(np.float32),
        (rng.random((W, k)) * 4000.0).astype(np.float32),
    )
    evicted = n_obs > W
    ev = (np.float32(37.5 if evicted else -np.inf), np.full(k, 12.0 if evicted else -np.inf, np.float32),
          np.float32(0.02 if evicted else -np.inf), np.full(k, 0.015 if evicted else -np.inf, np.float32))
    want = jax_sim._window_offsets(
        jnp.asarray(rt_stats), jnp.asarray(seg_stats), tuple(map(jnp.asarray, hist)), n_obs,
        tuple(map(jnp.asarray, ev)), 2.0, 100.0,
    )
    got = torch_sim._window_offsets(_t(rt_stats), _t(seg_stats), tuple(map(_t, hist)), n_obs, tuple(map(_t, ev)),
                                    2.0, 100.0)
    assert len(got) == len(want) == 4  # absolute, then relative (KS+)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PRED_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_relative_window_residuals_match_reference(seed):
    """KS+'s residuals: each divided by its floored prediction, batched
    over (lanes, steps) windows as ``_ksegments_offsets`` calls it."""
    W, k = 6, 4
    rng = np.random.default_rng(seed)
    rt_stats = np.stack([_observed_stats(30 + seed + i, 1, 5 + i)[0] for i in range(3)])
    seg_stats = np.stack([_observed_stats(40 + seed + i, k, 5 + i) for i in range(3)])
    hu = (rng.standard_normal((3, W)) * 1e9).astype(np.float32)
    hrt = (rng.random((3, W)) * 600.0).astype(np.float32)
    hpk = (rng.random((3, W, k)) * 4000.0).astype(np.float32)
    got = torch_sim._window_residuals(_t(rt_stats), _t(seg_stats), _t(hu), _t(hrt), _t(hpk), 2.0, 100.0)
    for i in range(3):
        want = jax_sim._window_residuals(jnp.asarray(rt_stats[i]), jnp.asarray(seg_stats[i]), jnp.asarray(hu[i]),
                                         jnp.asarray(hrt[i]), jnp.asarray(hpk[i]), 2.0, 100.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), **PRED_TOL)


def test_carry_round_trip_and_prediction_from_reference_state():
    """A reference host model's state moves into the port's carry and back
    unchanged, and the port predicts from it what the reference engine does."""
    trace = max(traces.generate_eager(seed=5, scale=0.12).tasks, key=lambda t: t.n_executions)
    model = KSegmentsModel(RefKConfig(k=4, error_mode="progressive"))
    for e in trace.executions[:6]:
        model.observe(e.input_size, e.series)
    state = model.state()
    back = carry_to_numpy(carry_from_numpy(state, "cpu", torch.float64))
    assert back.keys() == state.keys()
    for name, value in state.items():
        np.testing.assert_array_equal(back[name], value)

    carry = carry_from_numpy(state, "cpu", torch.float32)
    f32 = {n: np.asarray(state[n], np.float32) for n in ("rt_stats", "rt_over_err", "seg_stats", "seg_under_err")}
    for e in trace.executions[6:]:
        u = np.float32(e.input_size) - np.float32(carry["x0"])
        want = jax_sim._predict(
            jnp.asarray(f32["rt_stats"]), jnp.asarray(f32["rt_over_err"]), jnp.asarray(f32["seg_stats"]),
            jnp.asarray(f32["seg_under_err"]), jnp.asarray(u), 4, jnp.asarray(4), 2.0, 100.0,
        )
        got = torch_sim._predict(
            carry["rt_stats"], carry["rt_over_err"], carry["seg_stats"], carry["seg_under_err"], torch.tensor(u),
            4, 4, 2.0, 100.0,
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **PRED_TOL)


# -- simulate_task_methods: 9 methods x 2 error modes --------------------------

MODES = {"progressive": 0, "insample": 4}


@pytest.fixture(scope="module")
def corpus():
    """Every task of eager seed 5 at scale 0.12, zero-padded to one (B, T)
    so the reference compiles once per error mode (padded executions sit at
    the tail, where they feed nothing that is compared)."""
    tasks = traces.generate_eager(seed=5, scale=0.12).tasks
    B = max(t.n_executions for t in tasks)
    T = max(t.max_samples() for t in tasks)
    out = []
    for t in tasks:
        x, y, lengths = t.padded()
        n = t.n_executions
        xp, yp, lp = np.zeros(B), np.zeros((B, T), np.float32), np.zeros(B, np.int32)
        xp[:n], yp[:n, : y.shape[1]], lp[:n] = x, y, lengths
        out.append((t, xp, yp, lp))
    return out


@pytest.fixture(scope="module")
def outcomes(corpus):
    res = {}
    for mode, win in MODES.items():
        for t, x, y, lengths in corpus:
            want = jax_sim.simulate_task_methods(
                jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths), jnp.asarray(t.default_mib, jnp.float32),
                methods=torch_sim.ENGINE_METHODS, error_mode=mode, insample_window=win,
            )
            got = torch_sim.simulate_task_methods(
                x, y, lengths, t.default_mib, methods=torch_sim.ENGINE_METHODS, error_mode=mode,
                insample_window=win, device="cpu",
            )
            n = t.n_executions
            res[(mode, t.name)] = (
                tuple(np.asarray(a)[:, :n] for a in want),
                tuple(a.numpy()[:, :n] for a in got),
            )
    return res


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("method", torch_sim.ENGINE_METHODS)
def test_simulate_task_methods_matches_reference(corpus, outcomes, mode, method):
    mi = torch_sim.ENGINE_METHODS.index(method)
    for t, *_ in corpus:
        (w_ref, r_ref), (w_got, r_got) = outcomes[(mode, t.name)]
        np.testing.assert_array_equal(r_got[mi], r_ref[mi], err_msg=t.name)
        np.testing.assert_allclose(w_got[mi], w_ref[mi], err_msg=t.name, **WASTE_TOL)
    assert any(outcomes[(mode, t.name)][0][1][mi].any() for t, *_ in corpus) or method == "default"


def test_unported_methods_raise():
    """Every method of the reference engine runs; a name it does not know raises."""
    assert torch_sim.ENGINE_METHODS == jax_sim.ENGINE_METHODS
    trace = traces.generate_eager(seed=5, scale=0.12).tasks[0]
    x, y, lengths = trace.padded()
    with pytest.raises(ValueError, match="does not implement 'ks-plus'"):
        torch_sim.simulate_task_methods(x, y, lengths, trace.default_mib, methods=("default", "ks-plus"),
                                        device="cpu")
    with pytest.raises(ValueError, match="insample_window"):
        torch_sim.simulate_task_methods(x, y, lengths, trace.default_mib, error_mode="insample", device="cpu")
