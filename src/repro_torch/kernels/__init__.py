"""Hand-written Hopper kernels (``csrc/*.cu``), how they are built, their
dispatch, and the public kernels API (``api``, the port of ``repro.kernels``)."""

from repro_torch.kernels.api import attempt_wastage, fit_stats, flash_attention, segment_peaks

__all__ = ["attempt_wastage", "fit_stats", "flash_attention", "segment_peaks"]
