"""Hand-written Hopper kernels (``csrc/*.cu``), how they are built, and their dispatch."""
