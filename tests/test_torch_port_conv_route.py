"""K1's choice of path and the kernels' build naming, on the CPU.

K1 (``hcunet_tpu_torch/csrc/conv3d_valid.cu``) has two paths, picked from
(dtype, Cin, Cout) alone: the cp.async ring feeding wgmma for bfloat16 with
``Cin % 8 == 0``, and the basic path for the rest.  The CUDA tests in
``test_torch_port_cuda.py`` hold the C entry point to the same rule; these
tests hold the rule to the production U-Net's 15 serving convs.
"""

import shutil

import pytest
import torch

from hcunet_tpu_torch import csrc
from hcunet_tpu_torch.config import UNetConfig
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.models.unet import init_unet
from hcunet_tpu_torch.ops.conv import conv3d_valid_route

LAYER_NAMES = (
    [f"down{i}.conv{j}" for i in range(4) for j in (1, 2)]
    + [f"up{i}.conv{j}" for i in range(3) for j in (1, 2)]
    + ["out_conv"]
)


@pytest.fixture(scope="module")
def production_convs():
    """(Cin, Cout) of the 15 valid convs of ``production_3d``'s serving
    forward, in the order it runs them (a recording conv that returns
    zeros, so no arithmetic runs)."""
    model = init_unet(UNetConfig.production_3d(), torch.Generator().manual_seed(0))
    seen = []

    def recording_conv(x, w, b, relu):
        seen.append((x.shape[-1], w.shape[-1]))
        out = [s - k + 1 for s, k in zip(x.shape[1:4], w.shape[:3])]
        return torch.zeros((x.shape[0], *out, w.shape[-1]), dtype=x.dtype)

    apply = compile_serving_apply(model, dtype=torch.bfloat16, device="cpu", conv=recording_conv)
    apply(torch.zeros((1, 124, 124, 10, 4), dtype=torch.bfloat16))
    assert len(seen) == len(LAYER_NAMES)
    return dict(zip(LAYER_NAMES, seen))


@pytest.mark.parametrize("layer", LAYER_NAMES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_production_layers_take_the_ring_path_in_bf16(production_convs, layer, dtype):
    """14 of the 15 layers take the ring in bfloat16; the 4-channel first
    conv, and every float32 conv, take the basic path."""
    cin, cout = production_convs[layer]
    want = "ring" if dtype == torch.bfloat16 and layer != "down0.conv1" else "basic"
    assert conv3d_valid_route(dtype, cin, cout) == want
    assert (cin == 4) == (layer == "down0.conv1")


@pytest.mark.parametrize("cin", [1, 4, 5, 8, 12, 16, 24, 40, 128])
def test_route_follows_cin_alignment(cin):
    ring = cin % 8 == 0
    for cout in (1, 16, 24, 80, 128):
        assert conv3d_valid_route(torch.bfloat16, cin, cout) == ("ring" if ring else "basic")
        assert conv3d_valid_route(torch.float32, cin, cout) == "basic"


def test_library_path_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """Editing a ``csrc/*.cuh`` that a kernel includes renames its library,
    so a stale build is never loaded; a header it does not include does
    not."""
    for name in ("conv3d_valid.cu", "hopper_mma.cuh", "edt_pass.cu"):
        shutil.copy(csrc.CSRC_DIR / name, tmp_path / name)
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(csrc, "CSRC_DIR", tmp_path)
    assert tmp_path / "hopper_mma.cuh" in csrc._sources("conv3d_valid.cu")
    k1, k2 = csrc.library_path("conv3d_valid.cu"), csrc.library_path("edt_pass.cu")

    with open(tmp_path / "unused.cuh", "a") as f:
        f.write("// edited\n")
    assert csrc.library_path("conv3d_valid.cu") == k1

    with open(tmp_path / "hopper_mma.cuh", "a") as f:
        f.write("// edited\n")
    assert csrc.library_path("conv3d_valid.cu") != k1
    assert csrc.library_path("edt_pass.cu") == k2
