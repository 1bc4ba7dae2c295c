"""The port's test files share one autouse fixture: `cpu_share`."""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def cpu_share():
    """The module's torch ops take this worker's share of the cores (the
    CPU count over pytest-xdist's worker count, at least 1), restored after
    it. With every worker's OpenMP pool at the full count, the pools
    oversubscribe the cores and spin, and torch-heavy tests run 20-80x
    slower. `test_torch_train.py` keeps torch's default: its cycle-path
    gradient check at 32 px sits on a batch-norm variance that cancels in
    fp32 (ROADMAP R4), and with one thread the port's generator gradient
    there lands 13 % off the float64 reference that the default holds to
    1e-5."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    saved = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(saved)
