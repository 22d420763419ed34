"""K3's choice of path, on the CPU.

K3 (``hcunet_tpu_torch/csrc/dot_blocked.cu``) has two paths, picked from
(dtype, K, N) alone: the TMA ring feeding wgmma for bfloat16 with
``K % 8 == 0`` and ``N % 8 == 0``, and the basic path for the rest.  The
CUDA tests in ``test_torch_port_cuda.py`` hold the C entry point to the same
rule; these tests hold the rule to the production U-Net's 15 layer GEMMs and
to both sides of a multiple of 8, and check that a CPU tensor launches
nothing.
"""

import math
import shutil

import pytest
import torch

from hcunet_tpu_torch import csrc
from hcunet_tpu_torch.config import UNetConfig
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.models.unet import init_unet
from hcunet_tpu_torch.ops.dot import DOT_BLOCKED, dot_blocked, dot_blocked_plain, dot_blocked_route
from tests.test_torch_port_conv_route import LAYER_NAMES


@pytest.fixture(scope="module")
def production_gemms():
    """(K, N) of the GEMMs of the 15 valid convs of ``production_3d``'s
    serving forward (K = taps x Cin, N = Cout), recorded by a conv that
    returns zeros."""
    model = init_unet(UNetConfig.production_3d(), torch.Generator().manual_seed(0))
    seen = []

    def recording_conv(x, w, b, relu):
        seen.append((math.prod(w.shape[:4]), w.shape[-1]))
        out = [s - k + 1 for s, k in zip(x.shape[1:4], w.shape[:3])]
        return torch.zeros((x.shape[0], *out, w.shape[-1]), dtype=x.dtype)

    apply = compile_serving_apply(model, dtype=torch.bfloat16, device="cpu", conv=recording_conv)
    apply(torch.zeros((1, 124, 124, 10, 4), dtype=torch.bfloat16))
    assert len(seen) == len(LAYER_NAMES)
    return dict(zip(LAYER_NAMES, seen))


@pytest.mark.parametrize("layer", LAYER_NAMES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_production_layer_gemms_take_the_ring_path_in_bf16(production_gemms, layer, dtype):
    """14 of the 15 layer GEMMs take the ring in bfloat16 (down0.conv1's
    K = 72 among them); out_conv (N = 1), and every float32 GEMM, take the
    basic path."""
    k, n = production_gemms[layer]
    want = "ring" if dtype == torch.bfloat16 and layer != "out_conv" else "basic"
    assert dot_blocked_route(dtype, k, n) == want
    assert (n == 1) == (layer == "out_conv")


@pytest.mark.parametrize("k", [7, 8, 9, 13, 16, 24, 72, 767, 768, 2304])
def test_route_follows_k_and_n_alignment(k):
    for n in (1, 5, 8, 9, 16, 40, 127, 128, 384):
        want = "ring" if k % 8 == 0 and n % 8 == 0 else "basic"
        assert dot_blocked_route(torch.bfloat16, k, n) == want
        assert dot_blocked_route(torch.float32, k, n) == "basic"


@pytest.mark.parametrize("k, n", [(24, 16), (72, 40), (13, 8), (24, 5)])
def test_cpu_tensor_takes_the_plain_version(k, n):
    """Ring or basic by the rule, a CPU tensor runs the plain version and
    counts no launch on either path."""
    x = torch.randn((1, 3, 5, k), generator=torch.Generator().manual_seed(k)).to(torch.bfloat16)
    w = torch.randn((k, n), generator=torch.Generator().manual_seed(n)).to(torch.bfloat16)
    before, before_routes = DOT_BLOCKED.launches, dict(DOT_BLOCKED.route_launches)
    got = dot_blocked(x, w)
    assert DOT_BLOCKED.launches == before and DOT_BLOCKED.route_launches == before_routes
    assert set(before_routes) == {"ring", "basic"}
    assert torch.equal(got, dot_blocked_plain(x, w)) and got.shape == (1, 3, 5, n)


def test_library_path_hashes_headers_included_through_a_header(tmp_path, monkeypatch):
    """K3 includes ``hopper_tma.cuh``, which includes ``hopper_mma.cuh``:
    editing either renames K3's library; editing ``hopper_tma.cuh`` leaves
    K1's, which does not include it, as it was."""
    for name in ("conv3d_valid.cu", "dot_blocked.cu", "hopper_mma.cuh", "hopper_tma.cuh"):
        shutil.copy(csrc.CSRC_DIR / name, tmp_path / name)
    monkeypatch.setattr(csrc, "CSRC_DIR", tmp_path)
    assert {tmp_path / "hopper_tma.cuh", tmp_path / "hopper_mma.cuh"} <= set(
        csrc._sources("dot_blocked.cu")
    )
    k1, k3 = csrc.library_path("conv3d_valid.cu"), csrc.library_path("dot_blocked.cu")
    with open(tmp_path / "hopper_tma.cuh", "a") as f:
        f.write("// edited\n")
    assert csrc.library_path("conv3d_valid.cu") == k1
    k3_wide = csrc.library_path("dot_blocked.cu")
    assert k3_wide != k3
    with open(tmp_path / "hopper_mma.cuh", "a") as f:
        f.write("// edited\n")
    assert csrc.library_path("dot_blocked.cu") not in (k3, k3_wide)
    assert csrc.library_path("conv3d_valid.cu") != k1
