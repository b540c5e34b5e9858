"""k-Segments configuration and the learned state carried between runs.

The model itself (two regressions banks plus error offsets, Sec. III) lives
in the engine (``repro_torch.sim.torch_sim``), which evaluates it for every
execution of a task at once.  Here are its configuration (the fields of
``repro.core.ksegments.KSegmentsConfig`` that the engine reads; the retry
strategy comes with the method name) and the carry that moves its
learned state in and out of tensors: the flat dict that
``KSegmentsModel.state()`` of the reference returns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class KSegmentsConfig:
    k: int = 4  # paper default
    interval_s: float = 2.0  # paper's monitoring interval
    floor_mib: float = 100.0  # paper: 100 MB minimum when the model predicts < 0
    retry_factor: float = 2.0  # paper default l = 2
    # "insample": offsets are the extreme residuals of the current fit over
    # the history; "progressive": running max of one-step-ahead errors.
    error_mode: str = "insample"
    # Bounded-history insample: the last ``insample_window`` executions are
    # rescanned under the live fit; evicted ones keep their eviction-time
    # residual as a running maximum.  The engine needs it set (>= 1) in
    # insample mode.
    insample_window: int | None = None


_CARRY_ARRAYS = ("rt_stats", "rt_over_err", "seg_stats", "seg_under_err")


def carry_from_numpy(state: dict, device, dtype=torch.float32) -> dict:
    """Tensors of a k-Segments state dict (``rt_stats`` (5,),
    ``rt_over_err`` (), ``seg_stats`` (k, 5), ``seg_under_err`` (k,), and
    the input shift ``x0``, which stays a Python float)."""
    carry = {name: torch.as_tensor(np.asarray(state[name]), dtype=dtype, device=device) for name in _CARRY_ARRAYS}
    carry["x0"] = float(state["x0"])
    return carry


def carry_to_numpy(carry: dict) -> dict:
    """The state dict of a carry, as float64 numpy arrays."""
    state = {name: carry[name].detach().cpu().numpy().astype(np.float64) for name in _CARRY_ARRAYS}
    state["rt_over_err"] = float(state["rt_over_err"])
    state["x0"] = float(carry["x0"])
    return state
