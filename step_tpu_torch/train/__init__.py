"""Training: the progressive losses, the train step, the fit loop (port of
`step_tpu/train`)."""
