"""Inference-time utilities."""
