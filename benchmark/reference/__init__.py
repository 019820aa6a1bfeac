"""The plain reference: the detector and its training step in float32
PyTorch, importing nothing of the program."""
