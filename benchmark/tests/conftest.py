"""The benchmark's own tests. Tests marked ``cuda`` need a CUDA card and
skip without one; the card is looked for inside the ``cuda_device``
fixture, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")
