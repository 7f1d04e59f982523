"""Decoding and serving."""
