"""Measurement scripts of the port (they need a CUDA device)."""
