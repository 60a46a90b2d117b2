import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The tiny runs are many small ops: one process, few threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
