"""I3D backbone, detection heads and the progressive detector (port of
`step_tpu/models`)."""
