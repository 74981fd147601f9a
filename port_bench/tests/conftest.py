"""The benchmark's tests. Those marked `card` need a CUDA device and skip
without one; the decision is made inside the `card` fixture, never while a
module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size "
                    "runs on the card")
    return torch.device("cuda", 0)
