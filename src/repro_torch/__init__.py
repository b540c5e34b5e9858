"""PyTorch/CUDA port of the k-Segments system (``repro``'s twin).

``repro`` (JAX) stays the reference; this package imports ``torch`` and
``numpy`` only.  Entry points that touch tensors run on the CUDA card unless
the caller passes ``device="cpu"`` (see ``repro_torch.device``).  Its paths:
the evaluation engine (``sim/batch_engine``), the online predictor path (the
sequential oracle ``sim/simulator``, the baselines and Sizey, the
``MemoryPredictorService``, ``monitoring``, and the adaptive-k tuner
``core/ktuner``, whose replays run on the engine), the cluster scheduler
(``sim/cluster``: the batched path and its sequential oracle), LM serving
under k-Segments HBM admission (``launch/serve``), and the kernels API
(``repro_torch.kernels``: ``fit_stats``, ``segment_peaks``,
``attempt_wastage``, ``flash_attention``).  Their kernels (segmax, wastage,
rangemax, compaction, fitstats, flash) are CUDA C++ for ``sm_90a`` under
``repro_torch/kernels/csrc``; on CPU tensors their plain PyTorch versions
run.
"""
