"""The frozen arithmetic against hand counts, and the layer lists against
the convs the program calls (on the CPU, where each K1 call runs the
kernel's plain version)."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import flops
from portbench.tests.conftest import ROOT

UNET = json.loads((ROOT / "portbench/configs/unet3d-production.json").read_text())
RUNET = json.loads((ROOT / "portbench/configs/runet-default.json").read_text())


@pytest.mark.parametrize("n,p,k,want", [(5, 0, 3, 9), (5, 1, 3, 13), (4, 2, 5, 14), (1, 1, 3, 1)])
def test_in_range_taps_by_hand(n, p, k, want):
    # n=5, p=1, k=3: 5 outputs, the two edge ones see 2 taps inside: 3*5 - 2;
    # n=4, p=2, k=5: 4 outputs seeing 3, 4, 4 and 3 taps inside
    assert flops.in_range_taps(n, p, k) == want


def test_launch_operations_bytes_and_least_time_by_hand():
    launch = flops.Launch((2, 4, 5, 3, 8), (3, 3, 1), 16)
    out = (2, 3, 3)
    assert launch.out_shape() == out
    pairs = 2 * (2 * 3) * (3 * 3) * 3  # B * per-axis (output, tap) pairs
    assert launch.flops() == 2 * pairs * 8 * 16
    n_bytes = (2 * 4 * 5 * 3 * 8 + 9 * 8 * 16 + 2 * 2 * 3 * 3 * 16) * 2 + 16 * 4
    assert launch.bytes("bfloat16") == n_bytes
    assert launch.least_seconds("bfloat16") == max(2 * pairs * 128 / 989e12, n_bytes / 3.35e12)
    assert launch.least_seconds("float32") >= launch.flops() / 67e12


def test_a_grouped_launch_counts_the_work_it_needs():
    # two groups of 4 inputs: each output reads 4 of the 8 channels, and the
    # weights hold 9 taps x 4 x 16, not the dense form's 9 x 8 x 16
    launch = flops.Launch((2, 4, 5, 3, 8), (3, 3, 1), 16, groups=2)
    dense = flops.Launch((2, 4, 5, 3, 8), (3, 3, 1), 16)
    assert launch.flops() == dense.flops() / 2
    n_bytes = (2 * 4 * 5 * 3 * 8 + 9 * 4 * 16 + 2 * 2 * 3 * 3 * 16) * 4 + 16 * 4
    assert launch.bytes("float32") == n_bytes


def test_unet_layer_list_counts_the_configurations_work():
    """Over a tile batch, the layer list's operations are the U-Net's
    grouped convs' own (the model count at the tile's level sizes), not
    those of the dense weights K1 is handed."""
    launches = flops.unet_k1_launches(UNET, (384 + 112, 384 + 112, 15 + 8), 1)
    assert [l.groups for l in launches] == [2] * 14 + [1]
    first = launches[0]
    assert first.flops() == 2 * 494 * 494 * 22 * 18 * (4 // 2) * 16


def test_unet_model_flops_by_hand():
    # level 0: down 18*2*16 + 9*8*16, up 18*16*16 + 9*8*16, out 16; each
    # deeper level a quarter of the voxels; each transposed conv
    # 128 taps * 2f * f at the level below
    level0 = 576 + 1152 + 4608 + 1152 + 16
    level1 = (4608 + 4608 + 18432 + 4608) / 4
    level2 = (18432 + 18432 + 73728 + 18432) / 16
    level3 = (73728 + 73728) / 64
    tconv = 3 * 16384
    assert flops.unet_macs_per_voxel(UNET) == pytest.approx(
        level0 + level1 + level2 + level3 + tconv)
    assert flops.model_flops(UNET, 10) == pytest.approx(20 * flops.unet_macs_per_voxel(UNET))


def test_runet_model_flops_by_hand():
    # one timestep per voxel: down1 27*(9*16 + 16*16), up2's convs 27*(32*16 + 16*16),
    # out 16*5, up2's transposed conv 180*32*16 / 4; each gate 27*(16*32 + 32*32
    # + 64*32 + 32*32) / 4 + 27*(32*64 + 64*64) / 16 + 180*64*32 / 16
    per_step = (10800 + 20736 + 80 + 23040
                + 2 * (27 * (512 + 1024 + 2048 + 1024) / 4 + 27 * 6144 / 16 + 368640 / 16))
    assert flops.runet_macs_per_voxel(RUNET) == pytest.approx(10 * per_step)
    assert 2 * flops.runet_macs_per_voxel(RUNET) == pytest.approx(3.6736e6)


@pytest.fixture
def recorded_convs(monkeypatch):
    """Every call of K1's plain version: the input shape, padded as the
    kernel would see it, the kernel and the number of outputs."""
    from hcunet_tpu_torch.ops import conv as conv_mod

    calls = []
    plain = conv_mod.conv3d_valid_plain

    def record(x, w, bias=None, relu=False, dilation=1, padding=0):
        pads = conv_mod._padding3(padding)
        padded = tuple(s + lo + hi for s, (lo, hi) in zip(x.shape[1:4], pads))
        calls.append(((x.shape[0], *padded, x.shape[4]), tuple(w.shape[:3]), w.shape[4]))
        return plain(x, w, bias, relu, dilation, padding)

    monkeypatch.setattr(conv_mod, "conv3d_valid_plain", record)
    return calls


def _as_seen(launches):
    return [((l.x[0], *(s + 2 * p for s, p in zip(l.x[1:4], l.pad)), l.x[4]), l.kernel, l.cout)
            for l in launches]


def test_unet_layer_list_is_the_programs(recorded_convs):
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.models.unet import init_unet
    from portbench.entries.tiled_chunk import unet_config

    cfg = dict(UNET, feature_sizes=[4, 8, 16])
    tile = (100, 92, 11)
    apply_fn = compile_serving_apply(init_unet(unet_config(cfg)), dtype=torch.float32,
                                     device="cpu")
    apply_fn(torch.zeros((2, *tile, 4)))
    assert recorded_convs == _as_seen(flops.unet_k1_launches(cfg, tile, 2))


def test_runet_serving_layer_list_is_the_programs(recorded_convs):
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.models.runet import RecursiveUNet
    from portbench.entries.recurrent_serve import runet_config

    cfg = dict(RUNET, timesteps=2)
    shape = (16, 12, 3)
    apply_fn = compile_recurrent_apply(RecursiveUNet(runet_config(cfg)).eval(),
                                       dtype=torch.float32, device="cpu")
    apply_fn(torch.zeros((1, *shape, 4)))
    want = flops.runet_serve_k1_launches(cfg, shape, 1)
    assert len(want) == 40
    assert recorded_convs == _as_seen(want)
