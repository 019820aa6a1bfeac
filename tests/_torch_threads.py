"""Caps torch's intra-op threads in the port's tests.

Tier-1 runs the tests in six pytest workers on one machine. At torch's
default of one thread a core, six torch processes choke one another: a
test that takes 10 s alone took 60-240 s beside five others. The port's
test files import this module first; the tiny shapes they run gain little
from more threads, and one thread has no pool to oversubscribe.
"""

import torch

THREADS = 1

torch.set_num_threads(THREADS)
