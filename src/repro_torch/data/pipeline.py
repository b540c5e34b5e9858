"""Deterministic synthetic data pipeline.

Port of ``repro.data.pipeline``.  Synthetic-token LM data with document
packing: each "document" is a Markov chain over the vocab (so a small model
has learnable structure, unlike uniform noise), packed into fixed-length
rows with EOS separators and a loss mask.  Batches are deterministic in
(seed, step), and row ``b`` of a step draws from numpy's ``default_rng``
over ``SeedSequence([seed, step, b])``, as the reference's rows do: the
two packages give the same batches bit for bit, and a run restored from a
checkpoint consumes the identical stream.

``make_host_batch`` puts a step's batch on the device.  The reference's
``sharding`` argument (each host's shard of a global array) is not ported:
the port runs on one card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

EOS = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    order: int = 1  # markov order


class SyntheticLMData:
    """Deterministic (seed, step) -> batch generator."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse-ish markov transition: each state prefers a few successors
        self._succ = root.integers(2, v, size=(min(v, 4096), 8))

    def _document(self, rng: np.random.Generator) -> np.ndarray:
        n = max(int(rng.exponential(self.cfg.mean_doc_len)), 8)
        s = min(self.cfg.vocab_size, 4096)
        toks = np.empty(n, dtype=np.int32)
        toks[0] = rng.integers(2, self.cfg.vocab_size)
        for i in range(1, n):
            prev = toks[i - 1] % s
            toks[i] = self._succ[prev, rng.integers(0, 8)]
        return toks

    def _row(self, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        S = self.cfg.seq_len
        buf, mask = np.empty(S + 1, np.int32), np.ones(S + 1, np.int32)
        i = 0
        while i < S + 1:
            doc = self._document(rng)
            take = min(len(doc), S + 1 - i)
            buf[i : i + take] = doc[:take]
            i += take
            if i < S + 1:
                buf[i] = EOS
                i += 1
        return buf, mask

    def batch(self, step: int, rows: slice | None = None) -> dict[str, np.ndarray]:
        """Global (or row-sliced) batch for a step: tokens/labels/mask."""
        B, S = self.cfg.global_batch, self.cfg.seq_len
        idx = range(B)[rows] if rows is not None else range(B)
        toks = np.empty((len(idx), S), np.int32)
        labels = np.empty((len(idx), S), np.int32)
        masks = np.empty((len(idx), S), np.int32)
        for out_i, b in enumerate(idx):
            rng = np.random.default_rng(np.random.SeedSequence([self.cfg.seed, step, b]))
            row, mask = self._row(rng)
            toks[out_i] = row[:-1]
            labels[out_i] = row[1:]
            masks[out_i] = mask[1:]
        return {"tokens": toks, "labels": labels, "mask": masks}


def make_host_batch(data: SyntheticLMData, step: int, device=None) -> dict[str, torch.Tensor]:
    """The step's batch as int32 tensors on ``device`` (default: the CUDA
    card; raises without one)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
