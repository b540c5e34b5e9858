"""The port's synthetic data pipeline against the reference's, on the CPU:
the same (seed, step, rows) give the same batches, bit for bit."""

import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLMData as RefSyntheticLMData
from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
from repro_torch.data.pipeline import EOS


@pytest.mark.parametrize("seed,step,rows,cfg", [
    (0, 0, None, dict(vocab_size=512, seq_len=32, global_batch=4)),
    (0, 7, slice(1, 3), dict(vocab_size=512, seq_len=32, global_batch=4)),
    (3, 12, None, dict(vocab_size=50_000, seq_len=300, global_batch=3, mean_doc_len=64)),
    (11, 2, slice(None, None, 2), dict(vocab_size=9, seq_len=17, global_batch=5, mean_doc_len=4)),
    (5, 1_000_003, slice(4, 6), dict(vocab_size=151_936, seq_len=128, global_batch=6)),
])
def test_batches_equal_the_reference(seed, step, rows, cfg):
    ref = RefSyntheticLMData(RefDataConfig(seed=seed, **cfg)).batch(step, rows)
    got = SyntheticLMData(DataConfig(seed=seed, **cfg)).batch(step, rows)
    assert sorted(got) == sorted(ref) == ["labels", "mask", "tokens"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.int32 and np.array_equal(got[k], ref[k]), k


def test_batches_are_deterministic_and_shift_by_one():
    data = SyntheticLMData(DataConfig(vocab_size=512, seq_len=64, global_batch=3, seed=2, mean_doc_len=16))
    a, b = data.batch(4), data.batch(4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert (a["tokens"] == EOS).any() and a["mask"].all()
    assert not np.array_equal(a["tokens"], data.batch(5)["tokens"])


def test_make_host_batch_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    data = SyntheticLMData(DataConfig(vocab_size=512, seq_len=32, global_batch=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_batch(data, 0)
    got = make_host_batch(data, 3, device="cpu")
    want = data.batch(3)
    for k, t in got.items():
        assert t.dtype == torch.int32 and t.device.type == "cpu" and np.array_equal(t.numpy(), want[k])
