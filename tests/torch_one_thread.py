"""One intra-op torch thread for a test module of the port.

The port's CPU tests run tiny tensors, and the suite runs several
worker processes on the host's cores: torch's default of one intra-op
thread per core makes each worker's small ops contend with the others'
(a tiny training step runs many times slower).  A test module opts in
by importing the fixture:

    from torch_one_thread import one_torch_thread  # noqa: F401

It is module-scoped and autouse, so it is in force before the module's
other fixtures build their models, and it restores the count after the
module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
