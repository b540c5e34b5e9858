import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    """The harness's CPU runs are small: two threads each, so that test
    workers running side by side do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
