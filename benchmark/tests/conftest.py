"""Settings of the benchmark's own tests: the ``chip`` marker (tests that
need a CUDA card; they skip inside the ``chip`` fixture where there is none)
and the tiny configurations the CPU tests run the drivers at."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size on the chip")
    return torch.device("cuda:0")
