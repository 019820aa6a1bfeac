"""The benchmark of step_tpu_torch on one NVIDIA H100: the harness, its
configurations, traffic and metrics as data, and the plain reference."""
