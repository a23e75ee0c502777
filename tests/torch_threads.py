"""A fixture for the port's test files: torch on one intra-op thread.

The tier-1 run puts several test files side by side on a few cores; on
graphs of a few thousand nodes torch's thread pool only spins, and the
integer results do not depend on the thread count.  A file opts in with
`from torch_threads import one_torch_thread  # noqa: F401`.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
