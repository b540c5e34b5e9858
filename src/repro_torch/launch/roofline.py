"""Roofline of one call on the H100: model flops against what the call dispatches.

Port of ``repro.launch.roofline``.  The reference reads a compiled XLA
executable's ``cost_analysis()`` and parses its HLO for collectives; eager
PyTorch has neither, so ``derive`` counts one call of a function at
dispatch instead:

* flops through ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  ``mm``, ``bmm``, ``addmm``, convolutions, attention ops);
* bytes as the operand plus result bytes of every aten op that launches
  work (``analysis.trace_audit.NO_LAUNCH_OPS`` launch none).  That is per
  op and unfused, as XLA's "bytes accessed" is.

The hand-written kernels launch through ``ctypes``, not aten, so dispatch
cannot see their work: on CUDA tensors ``derive`` lists their launches
(``kernels.ops.launch_counts``) as *not counted* beside the totals.  On
CPU tensors every kernel runs as its plain version, which dispatches aten
ops, and is counted.

Every term divides by one card's peak; the port runs on one card:

    compute_term = flops / peak_flops_bf16
    memory_term  = bytes / hbm_bw

The bytes are what eager dispatch moves, op by op and unfused, without the
traffic of the kernels launched through ctypes: neither a lower bound on a
step's time nor the whole of its traffic.

Not ported: ``collective_bytes`` and its regexes, which parse XLA's HLO
text; the port has neither HLO nor collectives.
"""

from __future__ import annotations

import dataclasses

# NVIDIA's data sheet for the H100 SXM, dense rates without sparsity, at the
# full 700 W power limit: published peaks, not measurements of this port.
HW = {
    "peak_flops_bf16": 989e12,  # FLOP/s on the tensor cores
    "peak_flops_tf32": 495e12,  # FLOP/s on the tensor cores
    "peak_flops_f32": 67e12,  # FLOP/s outside the tensor cores
    "peak_flops_f64": 34e12,  # FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,  # B/s
}


def bound_ms(nbytes: float, nops: float, peak: float = HW["peak_flops_f32"]) -> tuple[float, str]:
    """The least time (ms) one card could take to move ``nbytes`` through
    device memory and do ``nops`` operations at ``peak`` per second: the
    larger of the two, and which it is (``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = nbytes / HW["hbm_bw"] * 1e3, nops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    model_flops_global: float
    # hand-written kernel launches whose work dispatch could not count
    not_counted: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / HW["peak_flops_bf16"]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HW["hbm_bw"]

    @property
    def collective_s(self) -> float:
        return 0.0  # one card: no collectives (the reference's NVLink/ICI term)

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def bound_s(self) -> float:
        """The larger term: the counted work's time at the card's peaks, with
        no overlap (not a lower bound; module docstring)."""
        return max(self.compute_s, self.memory_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops: how much of the dispatched compute is
        useful (catches remat recompute, masked attention, padding)."""
        return self.model_flops_global / self.flops_per_device if self.flops_per_device else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilization at ``bound_s``."""
        t = self.bound_s
        return self.model_flops_global / (HW["peak_flops_bf16"] * t) if t else 0.0

    def mfu(self, step_s: float) -> float:
        """Model-flops utilization at a measured step time."""
        return self.model_flops_global / (HW["peak_flops_bf16"] * step_s)

    def summary(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "not_counted": dict(self.not_counted),
        }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def derive(fn, cfg, shape) -> Roofline:
    """Run ``fn()`` once and count what it dispatches (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.trace_audit import LaunchCounter

    with FlopCounterMode(display=False) as flops, LaunchCounter() as lc:
        fn()
    return Roofline(
        flops_per_device=float(flops.get_total_flops()),
        bytes_per_device=float(lc.launching_bytes),
        model_flops_global=model_flops(cfg, shape),
        not_counted={k: n for k, n in lc.launches.items() if n},
    )
