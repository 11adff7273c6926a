"""Thread fixtures for the port's CPU tests.

Under pytest-xdist, torch's default of a thread a core oversubscribes the
cores, and OpenMP's waits stall every op.  A test file imports one of these
autouse fixtures; for the file's tests, its torch runs on that many
threads, and the processes it starts get ``OMP_NUM_THREADS`` to match.

    from torch_cores import share_of_the_cores  # noqa: F401
"""

import os

import pytest
import torch


def _threads(count: int):
    n = torch.get_num_threads()
    torch.set_num_threads(count)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(count))
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def share_of_the_cores():
    """This worker's share of the cores: all of them serially, one under
    ``-n 6`` on eight."""
    yield from _threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread, for files whose tests run several ranks side by side."""
    yield from _threads(1)
