"""Command-line entry points, run as modules: `python -m
step_tpu_torch.cli.train` and `python -m step_tpu_torch.cli.test` (ports of
the JAX package's `train.py` and `test.py`)."""
