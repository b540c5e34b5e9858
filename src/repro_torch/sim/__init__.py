"""Traces, the two-phase evaluation engine and the Fig. 7 and Fig. 8 entry points."""
