"""Prefill traffic: a closed loop of prefill calls, each a batch of prompts
of one shape, through the program's ``make_prefill_step`` with the cache
written.

Set-up draws each shape's pool of prompts and the weights, builds one
prefill step a shape (its cache ``T + cache_extra`` slots) and runs every
shape ``WARM`` times.  In the window each call uploads its prompts, runs
the step and waits for the logits (``synchronize``): its latency is the
host clock over all of it.  A seeded sample keeps the outputs of one call
of each of a shape's first ``ceil(sample_rows / B)`` prompts, so
``sample_rows`` distinct sequences a shape, copied once a call is picked:
the last position's logits and the cache.

Once the window has closed, the reference prefills each sampled call's
prompts in float32.  Numbers compared:
* ``logits_gap``: the largest over the shapes of the median over a
  shape's sampled sequences of the relative error of a sequence's logits
  (over the norm of the reference's logits about their mean), so that no
  shape can go wrong under the others' medians; ``logits_worst`` the
  largest error of a sequence;
* ``cache_gap``: the largest relative error of a row of the cache: a key
  or value row of a head at a slot (empty slots included), a layer's WKV
  state of a head, a token-shift row; slot positions must be equal.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from perfbench import harness, traffic as tr, weights
from perfbench.profile_reader import UNIT
from perfbench.reference import common

WARM = 2


class Cell:
    kind = "prefill"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *, faults: tuple[str, ...] = ()):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, torch.device(device)
        self.faults = faults
        self.shapes = [tuple(s) for s in traffic["shapes"]]
        self.longest = max(range(len(self.shapes)), key=lambda j: self.shapes[j][1])
        self.picks = [-(-traffic["sample_rows"] // B) for B, _ in self.shapes]
        if max(self.picks) > traffic["pool_per_shape"]:
            raise ValueError("sample_rows asks for more prompts of a shape than its pool holds")

    def setup(self) -> None:
        from repro_torch.serve.engine import make_prefill_step

        cfg = self.cfg
        self.pools = tr.prefill_pools(self.traffic, cfg["vocab_size"], self.seed)
        self.model = harness.build_model(cfg, self.seed, self.dev)
        mcfg = harness.port_config(cfg)
        extra = self.traffic["cache_extra"]
        self.steps = [make_prefill_step(mcfg, T + extra, device=self.dev) for _, T in self.shapes]
        self.used = [0] * len(self.shapes)
        for _ in range(WARM):
            for j in range(len(self.shapes)):
                self._call(j)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.used = [0] * len(self.shapes)

    def _call(self, j: int):
        pool = self.pools[j]
        i = self.used[j] % len(pool)
        self.used[j] += 1
        tokens = torch.from_numpy(pool[i]).to(self.dev)
        logits, cache = self.steps[j](self.model, {"tokens": tokens})
        if self.faults:
            logits, cache = _broken(logits, cache, self.faults, j == self.longest)
        return i, logits, cache

    def window(self, seconds: float, trace_units: int = 0):
        """Calls until ``seconds`` have passed and every shape has had one;
        with ``trace_units``, the calls of the window's second block of
        shapes, ``trace_units`` of them, are profiled."""
        order = tr.PrefillOrder(self.traffic, self.seed)
        sample = tr.Reservoir(1, self.seed)
        n = len(self.shapes)
        first, last = n, n + trace_units
        lat, tokens, failed, done = [], 0, 0, 0
        prof, self.units = None, []
        t0 = time.perf_counter()
        t_last = t0
        while True:
            j = order.next()
            if trace_units and done == first:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            traced = prof is not None and done < last
            a = time.perf_counter()
            with torch.profiler.record_function(UNIT) if traced else contextlib.nullcontext():
                i, logits, cache = self._call(j)
                ok = bool(torch.isfinite(logits).all())
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
            t_last = time.perf_counter()
            if traced:
                self.units.append(self.shapes[j])
                if done + 1 == last:
                    prof.stop()
            lat.append(t_last - a)
            failed += not ok
            tokens += self.shapes[j][0] * self.shapes[j][1]
            # kept as copies: a returned view (rwkv6's token shift at B = 1) would hold the program's buffer;
            # a traced call is not sampled, so that no copy falls inside the profiled stretch
            if i < self.picks[j] and not traced:
                sample.offer((j, i), lambda: (j, i, logits.clone(),
                                              [{k: t.clone() for k, t in c.items()} for c in cache]))
            done += 1
            # every shape is called at least once, and the traced calls are done
            if t_last - t0 >= seconds and done >= max(n, last if trace_units else 0):
                break
        self.attempted, self.failed, self.profile = done, failed, prof
        self.readings = sample.items()
        self.e2e = {"prefill_tokens_s": tokens / (t_last - t0),
                    "prefill_ms_p95": 1e3 * float(np.percentile(np.asarray(lat), 95))}

    def release(self) -> None:
        del self.model, self.steps
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, prec: common.Precision) -> list:
        cfg = self.cfg
        ref = harness.reference(cfg)
        specs = ref.param_specs(cfg)
        P = dict(weights.leaves(specs, self.seed, self.dev, f32=True))
        prec.store(P, {n: d for n, _, d, _ in specs})
        out = []
        with torch.no_grad(), common.no_tf32():
            for j, i, _, _ in self.readings:
                tokens = torch.from_numpy(self.pools[j][i]).to(self.dev).long()
                logits, cache = ref.prefill(P, tokens, cfg, prec, self.shapes[j][1] + self.traffic["cache_extra"])
                out.append((j, i, logits, cache))
        del P
        return out

    @staticmethod
    def compare(got: list, want: list) -> dict[str, float]:
        rows, cg = {}, 0.0
        for (j, _, l_g, c_g), (_, _, l_w, c_w) in zip(got, want):
            l_g, l_w = l_g.float(), l_w.float()
            den = (l_w - l_w.mean(-1, keepdim=True)).norm(dim=-1)
            err = (l_g - l_w).norm(dim=-1) / den
            rows.setdefault(j, []).extend(float(e) if math.isfinite(float(e)) else math.inf for e in err)
            for layer_g, layer_w in zip(c_g, c_w):
                for name, w in layer_w.items():
                    g = layer_g[name]
                    if name == "pos":
                        cg = max(cg, 0.0 if torch.equal(g.cpu(), w.cpu()) else math.inf)
                    else:
                        cg = max(cg, harness.row_gap(g, w, w.shape[-1] * (w.shape[-2] if name == "wkv" else 1)))
        medians = [sorted(r)[len(r) // 2] for r in rows.values()]
        return {"logits_gap": max(medians), "logits_worst": max(max(r) for r in rows.values()), "cache_gap": cg}


def _broken(logits, cache, faults: tuple[str, ...], longest: bool):
    """A fault planted where the answer is made, for the harness's own
    tests: ``answer`` returns the call's logits one sequence off (each
    sequence gets the one before's, a lone sequence its logits reversed);
    ``answer_longest`` does so only in the calls of the longest prompts;
    ``cache_unwritten`` leaves the last sequence's cache as it started
    (zeros, slots empty)."""
    if "answer" in faults or ("answer_longest" in faults and longest):
        logits = logits.roll(1, dims=0) if logits.shape[0] > 1 else logits.flip(-1)
    if "cache_unwritten" in faults:
        with torch.inference_mode():
            for layer in cache:
                for name, t in layer.items():
                    t[-1] = -1 if name == "pos" else 0
    return logits, cache
