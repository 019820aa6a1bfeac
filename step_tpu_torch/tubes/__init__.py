"""Box and tube math (port of `step_tpu/tubes`)."""
