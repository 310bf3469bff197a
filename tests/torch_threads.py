"""One torch CPU thread per test process, for the port's test files
(tests/test_torch_*.py import this module first).

Run with six xdist workers (`-n 6 --dist loadfile`), the test files
share the cores among six processes. Each process's default pool of
torch threads (one per core) spins between operations and starves the
other workers, the JAX references in interpret mode above all: a file of
the port's tests that takes about half a minute alone took over 1,000 s
in such a run. The port's plain versions are elementwise and order-fixed,
so their results do not depend on the thread count."""

import torch

torch.set_num_threads(1)
