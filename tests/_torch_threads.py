"""One intra-op thread for the port's CPU tests.

The suite runs in several worker processes at once (``-n 6``), and by
default each torch process starts an intra-op pool of one thread a core.
The port's CPU tests run many small ops (reduced models, AE banks of 784
x 128, decode steps of a few rows), where a pool of busy-waiting threads
a worker, six workers on the same cores, costs far more than it gives:
one example serve takes 4 s with one thread and 620 s with the default
pool when six run side by side on 8 cores. Each port test module takes
this fixture, which sets one thread for the module and restores the
count after it. The values are the same either way: every check holds
the port to the reference at a tolerance or to equal integers.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
