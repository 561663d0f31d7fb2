"""Caps torch's intra-op threads in the port's CPU tests.

Tier-1 runs the port's tests beside the JAX package's under pytest-xdist,
six workers on the host's CPUs; at torch's default of one thread per CPU
in every worker, the workers' threads oversubscribe the CPUs and every
test waits on the others. The port's test inputs are small, so one
thread a worker loses little (1 and 2 gave the same wall time, ~855 s on
8 CPUs; 1 the fewer worker-seconds). Every `test_torch_*` file imports
this module before its tests run (each worker imports every test file
while collecting, so the cap holds in every worker).
"""

import torch

THREADS = 1
torch.set_num_threads(THREADS)
