"""An autouse fixture for the port's heavier CPU test files: one torch
thread for the length of each test, the previous count restored after.

The tier-1 run has several pytest workers on one machine, each with torch's
default of a thread per core; the small eager ops of a protocol run then
wait on oversubscribed thread pools (measured on an 8-core machine beside
five busy processes: a 4-step protocol run took 146.6 s with 8 threads and
9.4 s with 1).  The numbers a test checks do not depend on the count beyond
the sum order its tolerances already allow.  Import it into a test module
(``from torch_threads import one_torch_thread  # noqa: F401``).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
