"""A fixture for the port's CPU test files (``from torch_threads import
one_torch_thread``): one intra-op torch thread while the importing file runs.

The suite's worker processes share the machine's cores; torch's thread pool
beside JAX's only makes them wait on one another (the same file runs several
times faster with one thread under a loaded suite). The earlier setting comes
back afterwards, for the files that follow in the same worker.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
