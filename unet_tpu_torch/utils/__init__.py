"""Checkpoint and weight-mapping helpers."""
