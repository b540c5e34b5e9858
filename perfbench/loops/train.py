"""Training traffic: optimizer steps back to back over a pool of batches.

Set-up builds one train state and one step (``make_train_step`` on
``init_train_state``) with the benchmark's weights, and drives that same
step through its first ``CHECKED`` steps on the pool's first batches,
each uploaded by the step as the program's trainer uploads one.  Those
steps warm every shape and give the readings that are compared: each
step's loss, each leaf's norm of the first gradient as the optimizer took
it (its first moment after one step, over 1 - b1), and each leaf's norm of
its change over the ``CHECKED`` steps (against the weights drawn again
from the seed).  The window then runs the same step on, batch after batch
of the pool, reading each step's loss as a trainer logs it.

The reference follows the same ``CHECKED`` steps in float32 from the same
weights and batches.  Numbers compared:
* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap of first-gradient norms, over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``update_gap``: the same of the change's norms, over the leaves whose
  reference gradient is at least ``MOVED`` of the median leaf's (a leaf
  the loss all but ignores moves by round-off under Adam).
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import harness, traffic as tr, weights
from perfbench.profile_reader import UNIT
from perfbench.reference import common

CHECKED = 3
MOVED = 1e-3


class Cell:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *, faults: tuple[str, ...] = ()):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, torch.device(device)
        self.faults = faults
        self.accum = traffic["accum_steps"]
        self.tokens_per_step = traffic["batch"] * traffic["seq_len"]

    # -- the program ---------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.train import OptimizerConfig, TrainConfig, init_train_state, make_train_step

        cfg = self.cfg
        self.pool = tr.train_pool(self.traffic, cfg["vocab_size"], self.seed)
        self.model = harness.build_model(cfg, self.seed, self.dev)
        opt = OptimizerConfig(**cfg["optimizer"])
        self.state = init_train_state(self.model, opt)
        step = make_train_step(harness.port_config(cfg), TrainConfig(accum_steps=self.accum, optimizer=opt),
                               self.model)
        self.step = _broken(step, self.model, cfg, self.faults) if self.faults else step
        self.next = 0
        losses = []
        for i in range(CHECKED):
            losses.append(self._one())
            if i == 0:
                b1 = cfg["optimizer"]["b1"]
                grad = {n: harness.norm(m) / (1 - b1) for n, m in self.state["opt"]["mu"].items()}
        params = self.state["params"]
        change = {n: harness.diff_norm(params[n], p0)
                  for n, p0 in weights.leaves(harness.reference(cfg).param_specs(cfg), self.seed, self.dev)}
        self.readings = {"loss": losses, "grad": grad, "change": change}

    def _one(self) -> float:
        batch = harness.upload(self.pool[self.next % len(self.pool)], self.dev)
        self.next += 1
        self.state, m = self.step(self.state, batch)
        return m["loss"].item()

    def window(self, seconds: float, trace_units: int = 0):
        """Steps until ``seconds`` have passed; with ``trace_units``, the
        window's second step and those after it, that many, are profiled."""
        prof = None
        done, failed = 0, 0
        t0 = time.perf_counter()
        t_last = t0
        while True:
            if trace_units and done == 1:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            if prof is not None and done < 1 + trace_units:
                with torch.profiler.record_function(UNIT):
                    loss = self._one()
                    torch.cuda.synchronize(self.dev)
                if done + 1 == 1 + trace_units:
                    prof.stop()
            else:
                loss = self._one()
            done += 1
            failed += not math.isfinite(loss)
            t_last = time.perf_counter()
            if t_last - t0 >= seconds and (not trace_units or done >= 1 + trace_units):
                break
        self.attempted, self.failed = done, failed
        self.profile = prof
        self.e2e = {"train_tokens_s": done * self.tokens_per_step / (t_last - t0)}
        self.units = [(self.traffic["batch"], self.traffic["seq_len"])] * trace_units

    def release(self) -> None:
        del self.model, self.state, self.step
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------

    def reference_readings(self, prec: common.Precision) -> dict:
        cfg = self.cfg
        ref = harness.reference(cfg)
        specs = ref.param_specs(cfg)
        P = dict(weights.leaves(specs, self.seed, self.dev, f32=True))
        served = {n: d for n, _, d, _ in specs}
        prec.store(P, served)
        batches = [harness.upload(self.pool[i], self.dev) for i in range(CHECKED)]
        period = len(cfg["port"]["block_pattern"])
        n_stacked = cfg["num_hidden_layers"] // period * period
        with common.no_tf32():
            out = common.train_readings(lambda p, mb: ref.loss(p, mb, cfg, prec), P, batches, cfg["optimizer"],
                                        n_stacked, self.accum, lambda p: prec.store(p, served))
        out["change"] = {n: harness.diff_norm(P[n], p0) for n, p0 in weights.leaves(specs, self.seed, self.dev,
                                                                                       f32=True)}
        del P
        return out

    @staticmethod
    def compare(got: dict, want: dict) -> dict[str, float]:
        loss = harness.worst(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["loss"], want["loss"]))
        grad = harness.norm_gap(got["grad"], want["grad"])
        med = sorted(want["grad"].values())[len(want["grad"]) // 2]
        moved = [n for n, g in want["grad"].items() if g >= MOVED * med]
        update = harness.norm_gap(got["change"], want["change"], moved)
        return {"loss_gap": loss, "grad_gap": grad, "update_gap": update}


def _broken(step, model, cfg: dict, faults: tuple[str, ...]):
    """The step with a fault planted underneath, for the harness's own
    tests: ``unchanged`` returns the state as it was (the loss computed,
    nothing updated); ``half_batch`` takes the first half of the batch's
    rows and the mean over them."""
    from repro_torch.train import make_loss_fn

    loss_fn = make_loss_fn(harness.port_config(cfg))

    def run(state, batch):
        if "half_batch" in faults:
            B = batch["tokens"].shape[0]
            batch = {k: v[:B // 2] for k, v in batch.items()}
        if "unchanged" in faults:
            with torch.no_grad():
                loss, _ = loss_fn(model, batch)
            return state, {"loss": loss}
        return step(state, batch)

    return run
