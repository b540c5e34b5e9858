"""The retry ladder: the port's ``torch_sim._replay`` on the CPU (the plain
loop ``wastage.replay_ladder_plain``) against the reference's
``jax_sim._replay_multi``, on the same seeded rows, in each precision
(float32 decisions and sums; float32 decisions with float64 sums, the
reference's x64 context; float64 throughout), recording and not, at retry
factors 2.0 and 1.2, over selective, partial and cap-jump methods, with
rows that exhaust the retry bound, ladders that fill ``max_attempts`` and
empty executions.

Tolerances: allocation values, failure indices, retries and attempt counts
exact (the same operations in the same type on both sides); attempt
wastage rtol 1e-5 / atol 1e-4 GiB*s when summed in float32, rtol 1e-9 /
atol 1e-9 in float64, because the sums over a series run in another
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim.jax_sim import _replay_multi
from repro_torch.core.predictor import retry_flags
from repro_torch.kernels import ops, wastage
from repro_torch.sim import torch_sim

# default and ksegments-selective bump one segment, ksegments-partial the
# failed one and every later one, ppm jumps to the node cap
METHODS = ("default", "ksegments-selective", "ksegments-partial", "ppm")
INTERVAL = 2.0
CAP_MIB = 4096.0
K = 4
PRECISIONS = {  # name -> (schedule dtype, accumulator dtype)
    "f32": (torch.float32, torch.float32),
    "f32-f64": (torch.float32, torch.float64),
    "f64": (torch.float64, torch.float64),
}
WASTE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.float64: dict(rtol=1e-9, atol=1e-9)}


def _minimal_row(T: int = 64):
    """500 MiB rising to 900 MiB from sample 40, against four 600 MiB
    segments ending at 16, 32, 48 and 64 s: the last segment fails at
    sample 40 until the bumps lift it past 900."""
    y = np.full(T, 500.0, dtype=np.float32)
    y[40:] = 900.0
    return y, np.array([16.0, 32.0, 48.0, 64.0]), np.full(K, 600.0)


def _rows(seed: int):
    """N = 2 lanes (k_eff 4 and 3) of B = 6 executions x the methods.
    Execution 0 of lane 0 is the minimal row; lane 1's execution 1 is empty;
    its execution 2 asks 1e-25 MiB, so no ladder converges before the
    retry bound (or the attempt slots)."""
    rng = np.random.default_rng(seed)
    N, B, M, T = 2, 6, len(METHODS), 96
    y = (rng.random((N * B, T)) * 1500.0 + 100.0).astype(np.float32)
    lengths = rng.integers(T // 2, T + 1, size=N * B).astype(np.int32)
    bounds = np.sort(rng.random((N, B, M, K)) * T * INTERVAL, axis=-1)
    bounds[..., -1] = np.inf
    values = np.sort(rng.random((N, B, M, K)) * 1200.0 + 200.0, axis=-1)
    y0, b0, v0 = _minimal_row()
    y[0, :64], y[0, 64:], lengths[0] = y0, 0.0, 64
    bounds[0, 0], values[0, 0] = b0, v0
    lengths[B + 1] = 0  # lane 1, execution 1: empty
    values[1, 2] = 1e-25
    series = np.arange(N * B, dtype=np.int32).reshape(N, B)
    k_eff = np.array([K, K - 1], dtype=np.int32)
    return y, lengths, series, bounds, values, k_eff


def _reference(y, lengths, series, bounds, values, k_eff, *, factor, max_attempts, x64, methods=METHODS):
    """The reference's ladder of every execution, one vmapped
    ``_replay_multi`` per lane, as numpy arrays in the port's (N, M, B, ...)
    layout."""
    sel, cap = (jnp.asarray(f) for f in retry_flags(methods))
    vdt = values.dtype
    outs = []
    with jax.enable_x64(x64):
        for n in range(series.shape[0]):
            s, ke = series[n], jnp.asarray(k_eff[n])

            def one(yy, ll, b, v, ke=ke):
                return _replay_multi(yy, ll, b, v, sel, cap, ke, interval_s=INTERVAL, factor=factor, cap_mib=CAP_MIB,
                                     max_attempts=max_attempts)

            out = jax.vmap(one)(jnp.asarray(y[s].astype(vdt)), jnp.asarray(lengths[s]),
                                jnp.asarray(bounds[n]), jnp.asarray(values[n]))
            outs.append(jax.tree_util.tree_map(np.asarray, out))
    waste = np.stack([o[0] for o in outs]).transpose(0, 2, 1)
    retries = np.stack([o[1] for o in outs]).transpose(0, 2, 1)
    if max_attempts is None:
        return waste, retries, None
    rec = tuple(np.stack([o[2][i] for o in outs]).swapaxes(1, 2) for i in range(4))
    return waste, retries, rec


def _port(y, lengths, series, bounds, values, k_eff, *, factor, max_attempts, vdt, acc):
    t = {name: torch.from_numpy(a) for name, a in
         dict(y=y, lengths=lengths, series=series, k_eff=k_eff).items()}
    return torch_sim._replay(
        t["y"], t["lengths"], t["series"], torch.from_numpy(bounds).to(vdt), torch.from_numpy(values).to(vdt),
        t["k_eff"], methods=METHODS, interval_s=INTERVAL, factor=factor, cap_mib=CAP_MIB,
        max_attempts=max_attempts, acc_dtype=acc,
    )


@pytest.mark.parametrize("max_attempts", [None, 8, 70])
@pytest.mark.parametrize("factor", [2.0, 1.2])
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_replay_matches_reference(precision, factor, max_attempts):
    vdt, acc = PRECISIONS[precision]
    y, lengths, series, bounds, values, k_eff = _rows(3)
    np_vdt = np.float32 if vdt == torch.float32 else np.float64
    bounds, values = bounds.astype(np_vdt), values.astype(np_vdt)
    x64 = acc == torch.float64  # the reference sums in float64 under x64
    want_w, want_r, want_rec = _reference(y, lengths, series, bounds, values, k_eff, factor=factor,
                                          max_attempts=max_attempts, x64=x64)
    got = _port(y, lengths, series, bounds, values, k_eff, factor=factor, max_attempts=max_attempts, vdt=vdt,
                acc=acc)
    assert got[0].dtype == acc and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), want_r)
    np.testing.assert_allclose(got[0].numpy(), want_w, **WASTE_TOL[acc])
    if max_attempts is None:
        assert want_r.max() == torch_sim.MAX_RETRIES + 1  # the 1e-25 MiB rows hit the bound
        assert want_r[1, :, 1].tolist() == [0] * len(METHODS) and (want_w[1, :, 1] == 0).all()  # the empty row
        return
    vbuf, fbuf, wbuf, natt = (a.numpy() for a in got[2])
    np.testing.assert_array_equal(natt, want_rec[3])
    np.testing.assert_array_equal(fbuf, want_rec[1])
    np.testing.assert_array_equal(vbuf, want_rec[0])
    np.testing.assert_allclose(wbuf, want_rec[2], **WASTE_TOL[acc])
    assert natt.max() == min(max_attempts, torch_sim.MAX_RETRIES + 1)  # full slots, or the retry bound
    assert (natt[1, :, 1] == 1).all() and (fbuf[1, :, 1, 0] == -1).all()  # the empty row: one success


def test_float64_ladder_multiplies_by_the_float64_factor():
    """The minimal row in float64 at factor 1.2: 600 -> 720 -> 864 -> 1036.8,
    each step ``v * 1.2`` in float64, as the reference's ladder (the factor
    once entered the float64 ladder rounded to float32)."""
    y0, b0, v0 = _minimal_row()
    y = y0[None]
    lengths = np.array([64], dtype=np.int32)
    series = np.zeros((1, 1), dtype=np.int32)
    bounds, values = b0[None, None, None], v0[None, None, None]
    _, _, rec = _reference(y, lengths, series, bounds, values, np.array([K], dtype=np.int32), factor=1.2,
                           max_attempts=8, x64=True, methods=("ksegments-selective",))
    t = [torch.from_numpy(a) for a in (y, lengths, series, bounds, values, np.array([K], dtype=np.int32))]
    _, retries, (vbuf, fbuf, _, natt) = torch_sim._replay(
        *t, methods=("ksegments-selective",), interval_s=INTERVAL, factor=1.2, cap_mib=CAP_MIB, max_attempts=8,
        acc_dtype=torch.float64,
    )
    last = vbuf[0, 0, 0, : int(natt[0, 0, 0]), -1].tolist()
    assert last == [600.0, 600.0 * 1.2, 600.0 * 1.2 * 1.2, 600.0 * 1.2 * 1.2 * 1.2]
    assert abs(last[-1] - 1036.8) < 1e-9 and int(retries[0, 0, 0]) == 3
    assert fbuf[0, 0, 0, :4].tolist() == [40, 40, 40, -1]
    np.testing.assert_array_equal(vbuf.numpy(), rec[0])


def test_replay_dispatch_takes_the_plain_loop_on_the_cpu():
    """A CPU tensor runs the plain loop and launches nothing; ``_replay`` is
    one ``ops.replay_ladder`` call either way."""
    y, lengths, series, bounds, values, k_eff = _rows(4)
    ops.reset_launch_counts()
    got = _port(y, lengths, series, bounds, values, k_eff, factor=2.0, max_attempts=8, vdt=torch.float32,
                acc=torch.float64)
    assert ops.launch_counts()["wastage"] == 0
    t = [torch.from_numpy(a) for a in (y, lengths, series)]
    sel, cap = retry_flags(METHODS)
    want = wastage.replay_ladder_plain(
        *t, torch.from_numpy(bounds).float(), torch.from_numpy(values).float(), torch.from_numpy(k_eff), sel, cap,
        interval_s=INTERVAL, factor=2.0, cap_mib=CAP_MIB, max_attempts=8, acc_dtype=torch.float64,
    )
    N, M, B = got[0].shape
    assert torch.equal(got[0], want[0].view(N, B, M).transpose(1, 2))
    assert torch.equal(got[2][0], want[2][0].view(N, B, M, 8, K).transpose(1, 2))


def test_replay_ladder_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain loop."""
    y, lengths, series, bounds, values, k_eff = (torch.from_numpy(a) for a in _rows(5))
    sel, cap = retry_flags(METHODS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wastage.replay_ladder_cuda(y, lengths, series, bounds.float(), values.float(), k_eff, sel, cap,
                                   interval_s=INTERVAL, factor=2.0, cap_mib=CAP_MIB)
