"""The port's adaptive-k tuner against the reference's
(``repro.core.ktuner.AdaptiveKSelector``), on the CPU: the reference replays
each candidate k through ``jax_sim.simulate_task_scan``, the port through
``torch_sim.simulate_task_methods`` with the same arguments.  The k each
reoptimisation picks (``history_k``) must be the reference's, and so must
the host model's predictions after it."""

import numpy as np
import pytest

from repro.core.ktuner import AdaptiveKSelector as RefSelector
from repro.sim import generate_eager as ref_generate_eager
from repro_torch.core.ktuner import AdaptiveKSelector
from repro_torch.sim import generate_eager

N_OBSERVED = 32  # as the reference's own test observes them


@pytest.fixture(scope="module")
def traces():
    return list(zip(generate_eager(seed=11, scale=0.3).eligible_tasks(20),
                    ref_generate_eager(seed=11, scale=0.3).eligible_tasks(20)))


@pytest.mark.parametrize("task", range(2))
def test_adaptive_k_matches_reference(traces, task):
    trace, ref_trace = traces[task]
    sel, ref = AdaptiveKSelector(refresh=8, device="cpu"), RefSelector(refresh=8)
    for e, re in zip(trace.executions[:N_OBSERVED], ref_trace.executions[:N_OBSERVED]):
        sel.observe(e.input_size, e.series)
        ref.observe(re.input_size, re.series)
    assert sel.history_k == ref.history_k
    assert len(sel.history_k) == min(trace.n_executions, N_OBSERVED) // 8
    assert sel.k == ref.k
    for e in trace.executions[N_OBSERVED:N_OBSERVED + 4]:
        a, b = sel.predict(e.input_size), ref.predict(e.input_size)
        np.testing.assert_array_equal(a.boundaries, b.boundaries)
        np.testing.assert_array_equal(a.values, b.values)


def test_adaptive_k_varies_by_task(traces):
    picked = set()
    for trace, _ in traces:
        sel = AdaptiveKSelector(refresh=8, device="cpu")
        for e in trace.executions[:N_OBSERVED]:
            sel.observe(e.input_size, e.series)
        picked.add(sel.k)
    assert len(picked) >= 2, picked
