"""One torch intra-op thread for the port's CPU parity tests.

These tests run many tiny torch ops.  By default torch keeps one
intra-op thread a core, and beside the other test processes on the same
cores those threads spin and wait on each other: on a loaded 8-core
machine a 32 x 256 order-2 cascade took ~50 ms with 8 threads and
0.17 ms with one.  The numbers do not depend on the thread count.  A test
module takes the fixture by importing it::

    from _torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the module runs, the old count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
