"""Predictor core of the port: regression banks, segmentation, allocation, the host k-Segments model, the event timeline."""
