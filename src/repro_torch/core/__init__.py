"""Predictor core of the port: regression banks, segmentation, allocation,
the host k-Segments model and its baselines, the predictor service, the
adaptive-k tuner and the event timeline (port of ``repro.core``)."""

from repro_torch.core.allocation import (
    AttemptOutcome,
    StepAllocation,
    attempt_outcomes_batch,
    run_with_retries_np,
    score_attempt_np,
    static_allocation,
)
from repro_torch.core.baselines import DefaultAllocator, TovarPPM, WittLR, make_baseline
from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
from repro_torch.core.ktuner import AdaptiveKSelector
from repro_torch.core.predictor import (
    METHODS,
    AllocationMethod,
    KSegmentsMethod,
    MemoryPredictorService,
    make_method,
)
from repro_torch.core.segmentation import segment_bounds, segment_peaks, segment_peaks_np
from repro_torch.core.sizey import SizeyPortfolio

__all__ = [
    "AttemptOutcome",
    "StepAllocation",
    "attempt_outcomes_batch",
    "run_with_retries_np",
    "score_attempt_np",
    "static_allocation",
    "DefaultAllocator",
    "TovarPPM",
    "WittLR",
    "make_baseline",
    "AdaptiveKSelector",
    "KSegmentsConfig",
    "KSegmentsModel",
    "METHODS",
    "AllocationMethod",
    "KSegmentsMethod",
    "MemoryPredictorService",
    "make_method",
    "segment_bounds",
    "segment_peaks",
    "segment_peaks_np",
    "SizeyPortfolio",
]
