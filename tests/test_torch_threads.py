"""PyTorch on one intra-op thread while a port test module runs.

The suite runs several test workers on one machine; a PyTorch pool of a
thread per core in each worker spends its time waiting for the other
workers' threads. Every `tests/test_torch_*.py` module imports the autouse
`one_torch_thread` fixture from here. Both sides of a port-against-port
comparison run under the same setting; comparisons with JAX keep their
stated tolerances.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one thread while the importing module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_torch_thread_is_in_force():
    assert torch.get_num_threads() == 1
