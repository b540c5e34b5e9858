"""PyTorch/CUDA port of the k-Segments system (``repro``'s twin).

``repro`` (JAX) stays the reference; this package imports ``torch`` and
``numpy`` only.  Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).  Its paths: the evaluation
engine (``sim/batch_engine``), the cluster scheduler (``sim/cluster``) and
LM serving under k-Segments HBM admission (``launch/serve``).  Their
kernels (segmax, wastage, rangemax, compaction, flash) are CUDA C++ for
``sm_90a`` under ``repro_torch/kernels/csrc``; on CPU tensors their plain
PyTorch versions run.
"""
