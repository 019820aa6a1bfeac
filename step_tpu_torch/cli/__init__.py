"""Command-line entry points, run as modules: `python -m
step_tpu_torch.cli.<name>` for `train`, `test`, `classify`, `export`,
`serve` and `demo` (ports of the JAX package's scripts of those names)."""
