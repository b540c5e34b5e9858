"""The port's copy of the trace generator gives byte-equal corpora and
packed batches to the reference's, seed for seed."""

import numpy as np
import pytest

from repro.sim import traces as ref
from repro_torch.sim import traces as port


def _same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,scale", [(0, 0.12), (7, 0.12), (0, 1.0)])
def test_suite_and_packing_are_byte_equal(seed, scale):
    got, want = port.generate_suite(seed=seed, scale=scale), ref.generate_suite(seed=seed, scale=scale)
    assert [wf.name for wf in got] == [wf.name for wf in want]
    for gw, ww in zip(got, want):
        assert len(gw.tasks) == len(ww.tasks)
        for gt, wt in zip(gw.tasks, ww.tasks):
            assert (gt.name, gt.workflow, gt.family, gt.default_mib, gt.interval_s) == (
                wt.name, wt.workflow, wt.family, wt.default_mib, wt.interval_s)
            assert len(gt.executions) == len(wt.executions)
            for ge, we in zip(gt.executions, wt.executions):
                assert ge.input_size == we.input_size
                _same(ge.series, we.series)
    gb = port.pack_traces([t for wf in got for t in wf.eligible_tasks(20)])
    wb = ref.pack_traces([t for wf in want for t in wf.eligible_tasks(20)])
    assert len(gb) == len(wb)
    for g, w in zip(gb, wb):
        assert [t.name for t in g.tasks] == [t.name for t in w.tasks]
        for field in ("x", "y", "lengths", "n_execs", "default_mib"):
            _same(getattr(g, field), getattr(w, field))


def test_bucket_sizes_match():
    for n in range(0, 3000, 7):
        assert port.bucket_size(n) == ref.bucket_size(n)
        assert port.fine_bucket(n, floor=2, step=2) == ref.fine_bucket(n, floor=2, step=2)
        assert port.fine_bucket(n) == ref.fine_bucket(n)
