"""Markers and the torch thread count of the PyTorch port's tests."""

import torch

# One torch thread in every test process: the CPU's float32 sums depend on
# the thread count, and the test workers share the machine's cores.
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere"
    )
