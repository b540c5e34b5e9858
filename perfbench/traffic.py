"""The one traffic generator: token streams from a traffic file's parameters.

The document rule is a frozen copy of the program's synthetic LM data
(``SyntheticLMData``): each document is a Markov chain over the vocabulary
(its first token uniform on [2, V); each next one of ``successors`` fixed
successors of the previous token's state, ``prev % states``, drawn
uniformly), of length ``max(int(Exponential(mean_len)), min_len)``; rows
are documents packed end to end with ``eos`` between them, cut at the row's
length.  The successor table and every draw come from numpy generators
seeded from (seed, stream), and rows are made all at once, a position at a
time across rows.

Two kinds of traffic:

* ``train``: a pool of ``pool`` batches of ``batch`` rows of ``seq_len``
  tokens (labels the next token, mask all ones), every row distinct;
  optimizer steps cycle through the pool in order.
* ``prefill``: calls of the ``shapes`` (B, T), in blocks that hold each
  shape once in a seeded order, so that every seed runs the same mix;
  each shape has a pool of ``pool_per_shape`` distinct prompts, used in
  turn; the check samples ``sample_rows`` sequences of each shape, as
  one call of each of its first ``ceil(sample_rows / B)`` prompts.
"""

from __future__ import annotations

import numpy as np

STREAM_TABLE, STREAM_DOCS, STREAM_ORDER, STREAM_SAMPLE = 0, 1, 2, 3


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream, *more]))


def successor_table(seed: int, vocab: int, doc: dict) -> np.ndarray:
    return rng(seed, STREAM_TABLE).integers(2, vocab, size=(min(vocab, doc["states"]), doc["successors"]))


def rows(seed: int, part: int, n_rows: int, length: int, vocab: int, doc: dict) -> np.ndarray:
    """(n_rows, length) int32 rows of packed documents, the ``part``-th set
    of the seed."""
    g = rng(seed, STREAM_DOCS, part)
    succ = successor_table(seed, vocab, doc)
    states = succ.shape[0]
    # what each position holds: 1 a document's first token, 2 the eos after one, 0 the chain's next
    kind = np.zeros((n_rows, length), np.int8)
    for r in range(n_rows):
        i = 0
        while i < length:
            n = max(int(g.exponential(doc["mean_len"])), doc["min_len"])
            kind[r, i] = 1
            i += n
            if i < length:
                kind[r, i] = 2
                i += 1
    firsts = g.integers(2, vocab, size=(n_rows, length))
    picks = g.integers(0, doc["successors"], size=(n_rows, length))
    out = np.empty((n_rows, length), np.int64)
    prev = np.zeros(n_rows, np.int64)
    for t in range(length):
        nxt = succ[prev % states, picks[:, t]]
        col = np.where(kind[:, t] == 1, firsts[:, t], np.where(kind[:, t] == 2, doc["eos"], nxt))
        out[:, t] = col
        prev = col
    return out.astype(np.int32)


def train_pool(traffic: dict, vocab: int, seed: int) -> list[dict[str, np.ndarray]]:
    """The pool of training batches: tokens, labels, mask (B, T) int32."""
    B, T, P = traffic["batch"], traffic["seq_len"], traffic["pool"]
    r = rows(seed, 0, B * P, T + 1, vocab, traffic["doc"])
    return [{"tokens": r[i * B:(i + 1) * B, :-1].copy(), "labels": r[i * B:(i + 1) * B, 1:].copy(),
             "mask": np.ones((B, T), np.int32)} for i in range(P)]


def prefill_pools(traffic: dict, vocab: int, seed: int) -> list[list[np.ndarray]]:
    """For each shape (B, T), its pool of prompts (B, T) int32."""
    out = []
    for j, (B, T) in enumerate(traffic["shapes"]):
        r = rows(seed, 1 + j, B * traffic["pool_per_shape"], T, vocab, traffic["doc"])
        out.append([r[i * B:(i + 1) * B] for i in range(traffic["pool_per_shape"])])
    return out


class PrefillOrder:
    """Which shape each call takes: blocks holding every shape once, each
    block in a seeded order."""

    def __init__(self, traffic: dict, seed: int):
        self.n = len(traffic["shapes"])
        self.g = rng(seed, STREAM_ORDER)
        self.block: list[int] = []

    def next(self) -> int:
        if not self.block:
            self.block = list(self.g.permutation(self.n))
        return int(self.block.pop(0))


class Reservoir:
    """A seeded uniform sample of ``size`` items a key from a stream of
    unknown length (Algorithm R).  ``offer`` decides first and calls
    ``make`` only for an item it keeps, so an item left out costs nothing."""

    def __init__(self, size: int, seed: int):
        self.size, self.g = size, rng(seed, STREAM_SAMPLE)
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, key, make) -> None:
        n = self.seen.get(key, 0)
        self.seen[key] = n + 1
        slot = self.kept.setdefault(key, [])
        if n < self.size:
            slot.append(make())
        else:
            j = int(self.g.integers(0, n + 1))
            if j < self.size:
                slot[j] = make()

    def items(self) -> list:
        return [it for key in sorted(self.kept) for it in self.kept[key]]
