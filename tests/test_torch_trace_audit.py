"""The port's dispatch audit, ``repro_torch.analysis.trace_audit``, on the CPU.

``LaunchCounter`` is held to exact counts on small calls (a kernel's launch
stands in through a counting stub of its wrapper, as on the card a launch
dispatches no aten op); ``no_rebuilds`` passes a warm repeat and raises on a
changed count or a library load; a reduced ``simulate_grid`` dispatches the
same aten ops on two warm runs; ``check_dtypes`` flags a float32 op in a
float64 function and passes the float64 fit-table and fold programs of
``sim/device_timeline.py``; ``large_uploads`` finds a host tensor uploaded
on every call (uploads go to the ``meta`` device here: a copy from the host
to any other device is one).  Counts are exact; nothing is timed."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.analysis import trace_audit
from repro_torch.analysis.trace_audit import (
    NO_LAUNCH_OPS,
    LaunchCounter,
    RebuildError,
    Upload,
    check_dtypes,
    large_uploads,
    no_rebuilds,
)
from repro_torch.core.segmentation import segment_peaks_dynamic
from repro_torch.kernels import build, ops, segmax
from repro_torch.sim import device_timeline


def _counting_segmax(y, lengths, series, k_eff, k_max):
    """Stands in for ``segmax_cuda``: counts a launch and, like a launch,
    dispatches no aten op."""
    segmax.launches += 1
    with _disable_current_modes():
        return segment_peaks_dynamic(y[series], lengths[series], k_eff, k_max)


@pytest.fixture
def card_route(monkeypatch):
    monkeypatch.setattr(ops, "_route", lambda y: True)
    monkeypatch.setattr(segmax, "segmax_cuda", _counting_segmax)


def _peaks_args(rows: int = 6, T: int = 32):
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((rows, T), dtype=np.float32))
    lengths = torch.full((rows,), T, dtype=torch.int32)
    series = torch.arange(rows, dtype=torch.int32)
    return y, lengths, series, torch.full((rows,), 4, dtype=torch.int32), 4


def test_counter_counts_ops_readbacks_and_nothing_else():
    x = torch.arange(6.0)
    with LaunchCounter() as lc:
        y = x.view(2, 3).sum(dim=1)  # a view launches nothing; the sum launches
        v = y[0].item()  # select launches nothing; the read-back does
    assert v == 3.0
    assert dict(lc.aten) == {"sum": 1, "_local_scalar_dense": 1}
    assert lc.launching_ops == 2 and lc.readbacks == 1
    assert lc.uploads == [] and lc.builds == 0 and lc.loads == 0
    assert not any(lc.launches.values())
    # operand and result bytes of the launching ops: sum reads 6 floats and
    # writes 2; the read-back reads one
    assert lc.launching_bytes == 4 * (6 + 2) + 4


def test_counter_sees_one_segmax_launch_a_call(card_route):
    args = _peaks_args()
    with LaunchCounter() as lc:
        for _ in range(3):
            ops.segment_peaks(*args)
    assert lc.launches["segmax"] == 3
    assert sum(lc.launches.values()) == 3
    assert lc.launching_ops == 0  # the wrapper dispatches nothing that launches


def test_counter_counts_uploads_and_their_bytes():
    table = np.ones((16, 8))
    with LaunchCounter() as lc:
        a = torch.from_numpy(table).to("meta")  # an upload: host -> device
        b = torch.empty(4, device="meta").copy_(torch.ones(4))  # another
        torch.ones(4).double()  # host to host: no upload
    assert a.device.type == b.device.type == "meta"
    assert lc.uploads == [Upload((16, 8), "torch.float64", 16 * 8 * 8), Upload((4,), "torch.float32", 16)]
    assert lc.upload_bytes == 16 * 8 * 8 + 16 and lc.readbacks == 0


def test_transfer_classifies_readbacks():
    host, dev = torch.zeros(3), torch.zeros(3, device="meta")
    assert trace_audit._transfer("copy_", (host, dev), host) == ("readback", host)
    assert trace_audit._transfer("_to_copy", (dev,), host) == ("readback", host)
    assert trace_audit._transfer("_to_copy", (host,), dev) == ("upload", dev)
    assert trace_audit._transfer("_to_copy", (host,), host) is None
    assert trace_audit._transfer("add", (host, host), host) is None
    # torch.tensor(data, device=...) hands lift_fresh the device tensor
    assert trace_audit._transfer("lift_fresh", (dev,), dev) == ("upload", dev)
    assert trace_audit._transfer("lift_fresh", (host,), host) is None


def test_counter_stops_counting_after_exit():
    with LaunchCounter() as lc:
        torch.ones(2).sum()
    torch.ones(2).sum()
    assert dict(lc.aten) == {"ones": 1, "sum": 1}


def test_counter_counts_library_builds_and_loads(monkeypatch):
    monkeypatch.setattr(build, "loads", build.loads)
    monkeypatch.setattr(build, "builds", build.builds)
    with LaunchCounter() as lc:
        build.loads += 2
        build.builds += 1
    assert (lc.builds, lc.loads) == (1, 2)


def test_launching_ops_skips_views_and_allocations():
    x = torch.ones(4, 4)
    assert trace_audit.launching_ops(lambda: x.t().unsqueeze(0).expand(3, 4, 4)) == 0
    assert trace_audit.launching_ops(lambda: x.t().reshape(16)) == 1  # a copy: t() is not contiguous
    assert trace_audit.launching_ops(lambda: (x + 1).sum()) == 2
    ops_seen, out = trace_audit.dispatched_ops(lambda: torch.empty(3).view(3))
    assert ops_seen == ["empty", "view"] and set(ops_seen) <= NO_LAUNCH_OPS and out.shape == (3,)


def test_no_rebuilds_passes_a_warm_repeat_and_raises_on_a_change(card_route):
    args = _peaks_args()

    def call():
        return ops.segment_peaks(*args).sum()

    with LaunchCounter() as cold:
        call()
    expect = {k: n for k, n in cold.launches.items() if n}
    assert expect == {"segmax": 1}
    with no_rebuilds("warm peaks", launches=expect, launching_ops=cold.launching_ops) as lc:
        call()
    assert lc.launching_ops == cold.launching_ops == 1
    with pytest.raises(RebuildError, match=r"launches \(expected, got\) \{'segmax': \(1, 2\)\}"):
        with no_rebuilds("twice", launches=expect):
            call()
            call()
    with pytest.raises(RebuildError, match="3 launching aten ops, expected 1"):
        with no_rebuilds("more ops", launching_ops=1):
            call()
            torch.ones(2).sum()
    with pytest.raises(RebuildError, match=r"0 kernel library\(ies\) built and 1 loaded"):
        with no_rebuilds("a load"):
            build.loads += 1


def test_reduced_grid_dispatches_the_same_ops_on_two_warm_runs():
    from repro_torch.core.ksegments import KSegmentsConfig
    from repro_torch.sim.batch_engine import simulate_grid
    from repro_torch.sim.simulator import SimConfig
    from repro_torch.sim.traces import generate_eager

    wfs = [generate_eager(seed=5, scale=0.12)]
    cfg = SimConfig(min_executions=8, ksegments=KSegmentsConfig(k=4, error_mode="insample", insample_window=64))
    simulate_grid(wfs, cfg=cfg, device="cpu")  # cold
    runs = []
    for _ in range(2):
        with no_rebuilds("warm grid", launches={}) as lc:
            simulate_grid(wfs, cfg=cfg, device="cpu")
        runs.append(lc)
    assert runs[0].launching_ops > 100
    assert runs[0].aten == runs[1].aten
    assert runs[0].readbacks == runs[1].readbacks  # .cpu() of a host tensor dispatches nothing
    assert runs[0].uploads == runs[1].uploads == []  # everything lies on the host here


def test_check_dtypes_flags_a_float32_factor_in_a_float64_program():
    x = torch.linspace(1.0, 2.0, 8, dtype=torch.float64)

    def rounded_factor(v):  # the factor rounded to float32 before it multiplies
        return v * torch.tensor(1.2, dtype=torch.float32).double()

    def exact_factor(v):
        return v * torch.tensor(1.2, dtype=v.dtype)

    problems = check_dtypes(rounded_factor, x, forbid_dtypes=(torch.float32,))
    assert problems == ["lift_fresh gave torch.float32 ()"]
    assert check_dtypes(exact_factor, x, forbid_dtypes=(torch.float32,)) == []
    assert check_dtypes(rounded_factor, x) == []  # nothing forbidden


def _event_rows(R: int, L: int, seed: int):
    """Sorted event times with a +inf tail, deltas in MiB, base demands."""
    rng = np.random.default_rng(seed)
    t = np.sort(np.round(rng.random((R, L)) * 5e3, 1), axis=1)
    fin = np.arange(L)[None, :] < rng.integers(L // 4, L + 1, size=R)[:, None]
    t = np.where(fin, t, np.inf)
    d = np.where(fin, np.round(rng.standard_normal((R, L)) * 4096.0, 3), 0.0)
    base = np.round(rng.random(R) * 65536.0, 2)
    return [torch.from_numpy(a) for a in (t, d, base)]


@pytest.mark.parametrize("dtype,clean", [(torch.float64, True), (torch.float32, False)])
def test_check_dtypes_on_the_fit_table_program(dtype, clean):
    t, d, base0 = (a.to(dtype) for a in _event_rows(16, 64, 1))
    problems = check_dtypes(device_timeline._fit_tables, t, d, base0, forbid_dtypes=(torch.float32,))
    assert (problems == []) == clean
    if not clean:
        assert any(p.endswith("(16, 64)") for p in problems)


def test_check_dtypes_passes_the_float64_fold():
    S, N, L = 3, 4, 64
    t, d, base = _event_rows(S * N, L, 2)
    now = torch.tensor([-1.0, 2.5e3, 1e4], dtype=torch.float64)
    out = []
    problems = check_dtypes(lambda: out.append(device_timeline._fold_and_compact(
        now, base.view(S, N), t.view(S, N, L), d.view(S, N, L))), forbid_dtypes=(torch.float32,))
    assert problems == []
    assert out[0][3].dtype == torch.float64 and out[0][4].shape == (S,)


def test_large_uploads_finds_a_table_uploaded_every_call():
    table = np.ones((512, 512))  # 2 MiB of float64
    small = np.ones(16)
    x = torch.zeros(512, 512, dtype=torch.float64, device="meta")

    def step(v):
        return v + torch.from_numpy(table).to(v.device) + torch.from_numpy(small).to(v.device).sum()

    assert large_uploads(step, x, min_bytes=1 << 20) == [Upload((512, 512), "torch.float64", 512 * 512 * 8)]
    kept = torch.from_numpy(table).to("meta")
    assert large_uploads(lambda v: v + kept, x, min_bytes=1 << 20) == []
    assert [u.nbytes for u in large_uploads(step, x, min_bytes=0)] == [512 * 512 * 8, 16 * 8]
