"""The method names and their retry policies (port of the tables in
``repro.core.predictor``).

A "cap jump" method reassigns the node's full memory on failure (original
PPM); every other method multiplies by the retry factor: only the failed
segment for selective methods, the failed segment onward for partial.  For
the k = 1 baselines the two coincide, so they ride selective.
"""

from __future__ import annotations

METHODS = (
    "default",
    "witt-lr",
    "witt-lr-max",
    "ppm",
    "ppm-improved",
    "ksegments-selective",
    "ksegments-partial",
    "sizey",
    "ksplus",
)

RETRY_SELECTIVE = {m: m != "ksegments-partial" for m in METHODS}
RETRY_CAP_JUMP = {m: m == "ppm" for m in METHODS}


def retry_flags(methods: tuple[str, ...]) -> tuple[tuple[bool, ...], tuple[bool, ...]]:
    """(selective, cap_jump) flag rows for a method tuple, in row order."""
    return (
        tuple(RETRY_SELECTIVE[m] for m in methods),
        tuple(RETRY_CAP_JUMP[m] for m in methods),
    )
