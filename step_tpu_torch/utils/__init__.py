"""Utilities (port of `step_tpu/utils`)."""
