"""Predictor core of the port: regression banks, segmentation, allocation."""
