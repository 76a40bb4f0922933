"""One CPU thread for the port's CPU tests, for the whole of a test module.

    from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

The tests run at smoke sizes, where torch's intra-op threads and numpy's
OpenBLAS threads gain nothing, and the suite runs in several worker processes
on one machine: each worker's default pools (a thread a core) oversubscribe
the cores, and OpenBLAS's spinning threads then run a 2048 × 1024 QR 20
times slower than one thread does. The fixture bounds both pools to one
thread while the module's tests run and restores them afterwards.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # no BLAS pool control: torch's bound alone
    threadpool_limits = None


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    blas = threadpool_limits(1) if threadpool_limits is not None else contextlib.nullcontext()
    with blas:
        yield
    torch.set_num_threads(n)
