"""One intra-op thread for the port's tests on the CPU.

The port's plain versions run many small tensor ops from Python loops. When
the suite runs in several worker processes, the OpenMP workers of each
process spin for cores that the other processes hold, and a module of these
tests runs several times slower than it does alone. The tests use small
shapes, where one thread loses nothing. Each ``tests/test_torch_*.py``
imports this module.
"""

import torch

torch.set_num_threads(1)
