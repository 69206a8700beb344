"""One torch thread for every test of the PyTorch port.

Each `tests/test_torch_*.py` imports `one_torch_thread`, a module-scoped
autouse fixture, so that its tests run on one intra-op thread and restore
the count afterwards. The suite runs several worker processes on a host
with few cores: at PyTorch's default thread count each worker spins as many
threads as there are cores, and the workers stall one another.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
