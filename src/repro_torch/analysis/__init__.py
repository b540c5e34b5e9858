"""repro_torch.analysis — the port's static analysis and dispatch audit.

Port of ``repro.analysis``.  The port's correctness rests on disciplines of
its own: it imports nothing of jax or the reference, it runs on the card
unless the caller asks for the CPU and never falls back quietly, its
float64 scheduling programs stay float64, and its device programs keep host
read-backs out of their loops.  This package makes them machine-checked:

* **Layer 1 — AST lint** (``python -m repro_torch.analysis <paths>``,
  console script ``repro-torch-analysis``): the reference's rule engine
  with the port's rules RT001-RT005 (``repro_torch.analysis.rules``),
  inline ``# rt: ignore[RT00X]`` suppressions and a checked-in baseline of
  grandfathered findings, each with its reason
  (``.repro-torch-analysis-baseline.json``).
* **Layer 2 — dispatch audit** (``repro_torch.analysis.trace_audit``):
  launch, read-back, upload and rebuild counts of a block
  (``LaunchCounter``, ``no_rebuilds``), a float64 guard over every result
  a program dispatches (``check_dtypes``), and the uploads a call repeats
  (``large_uploads``).

The lint layer is stdlib-only (no torch import); the audit layer imports
torch.
"""

from repro_torch.analysis.engine import AnalysisResult, analyze_paths, iter_py_files
from repro_torch.analysis.rules import RULES, Finding, check_source

__all__ = [
    "AnalysisResult",
    "Finding",
    "RULES",
    "analyze_paths",
    "check_source",
    "iter_py_files",
]
