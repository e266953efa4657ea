"""One torch intra-op thread for the port's CPU tests.

The tests run as several pytest-xdist workers on one host. torch's default
pool of intra-op threads (one per core) in every worker oversubscribes the
cores, and the port's many small eager ops then run many times slower than
alone. Every ``tests/test_torch_*.py`` imports this module at module level;
xdist collects every file in every worker, so every worker runs with one
thread. (``torch.set_num_interop_threads`` is not called: it raises once
inter-op work has started.)
"""

import torch

torch.set_num_threads(1)
