"""PyTorch/CUDA port of the k-Segments evaluation engine (``repro``'s twin).

``repro`` (JAX) stays the reference; this package imports ``torch`` and
``numpy`` only.  Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).  The two kernels on the main
path, segmax and wastage, are CUDA C++ for ``sm_90a`` under
``repro_torch/kernels/csrc``; on CPU tensors their plain PyTorch versions run.
"""
