"""Config, checkpoint and weight-mapping helpers."""
