"""Pytest markers of the PyTorch port's tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere"
    )
