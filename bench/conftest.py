"""The benchmark's tests: the ``card`` marker, for tests that need a CUDA
device; the ``card`` fixture skips them where there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size "
                    "runs on the chip")
    return torch.device("cuda:0")
