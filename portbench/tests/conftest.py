"""Small sizes at which the benchmark's cells run on the CPU in a test."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

# the tests run several workers at once: a few threads each keep the CPU's
# convs from crowding one another out
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a 2-level U-Net of the production kernels, with a halo that covers its
# shrink (10, 10, 2); the RecursiveUNet at two timesteps
UNET = {"feature_sizes": [4, 8], "tiles": {"eval_size": [16, 16, 5], "pad": [10, 10, 2], "batch": 2}}
RUNET = {"timesteps": 2}

SMALL = {
    "unet3d-f32-chunk2304": {"config": UNET,
                             "mix": {"shape": [40, 36, 7], "pool": 2, "trace_requests": 2}},
    "unet3d-bf16-predict-mixed": {"config": UNET,
                                  "mix": {"ranges": {"x": [20, 40], "y": [20, 40], "z": [4, 6]},
                                          "pool": 4, "trace_requests": 3}},
    "runet-bf16-b1-256": {"config": RUNET,
                          "mix": {"shape": [32, 32, 4], "pool": 3, "trace_requests": 3,
                                  "sample": 2}},
}


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
