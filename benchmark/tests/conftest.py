import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips with a reason without one)")


@pytest.fixture
def card():
    """The first CUDA card; the test skips without one (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
