"""Each plain reference against the port's CPU path at tiny sizes: the
same weights and inputs, float32, agreeing to float32 rounding."""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench import bench
from portbench.inputs import make_volume, make_weights
from portbench.reference.precision import Precision
from portbench.tests.conftest import ROOT, RUNET, UNET

UNET_REF = bench.load_module(bench.reference_path("unet3d-production"))
RUNET_REF = bench.load_module(bench.reference_path("runet-default"))
UNET_CFG = {**json.loads((ROOT / "portbench/configs/unet3d-production.json").read_text()), **UNET}
RUNET_CFG = {**json.loads((ROOT / "portbench/configs/runet-default.json").read_text()), **RUNET}
F32 = Precision("float32", "cpu")


def _run(cfg, seed=3):
    ref = UNET_REF if cfg["family"] == "unet3d" else RUNET_REF
    return type("R", (), {"config": cfg, "device": torch.device("cpu"),
                          "weights": make_weights(ref.param_specs(cfg), seed, "cpu")})()


def test_unet_reference_tiles_as_the_port_does():
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
    from portbench.entries.tiled_chunk import build_model, tile_config

    run = _run(UNET_CFG)
    model = build_model(run)
    vol = make_volume((37, 41, 6), 5, "cpu")
    apply_fn = compile_serving_apply(model, dtype=torch.float32, device="cpu")
    got = predict_segmentation_mask(apply_fn, vol[None], model.config, tile_config(UNET_CFG),
                                    use_probability_map=True, device="cpu")[0, ..., 0]
    want = UNET_REF.tiled_map(run.weights, UNET_CFG, vol, F32)
    assert got.shape == want.shape == (37, 41, 6)
    assert float((got - want).abs().max()) < 1e-5
    assert float(want.std()) > 0.01  # the map is not flat


def test_unet_reference_buckets_as_the_segmenter_does():
    from hcunet_tpu_torch.infer.serving import Segmenter
    from portbench.entries.tiled_chunk import build_model, tile_config

    run = _run(UNET_CFG)
    seg = Segmenter(build_model(run), tile_cfg=tile_config(UNET_CFG), dtype=torch.float32,
                    device="cpu")
    for shape in ((37, 20, 4), (17, 33, 6)):
        vol = make_volume(shape, 6, "cpu")
        got = seg.predict(vol.numpy())
        want = UNET_REF.bucketed_map(run.weights, UNET_CFG, vol, F32).numpy()
        assert got.shape == want.shape == shape
        assert np.abs(got - want).max() < 1e-5


def test_runet_reference_serves_as_the_port_does():
    from portbench.entries.recurrent_serve import build_model

    run = _run(RUNET_CFG)
    model = build_model(run).eval()
    image = make_volume((16, 12, 3), 7, "cpu")[None]
    with torch.no_grad():
        got = model(image)
    want = RUNET_REF.serve(run.weights, RUNET_CFG, image, F32)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_the_controls_round_as_stated():
    # TF32 keeps 10 mantissa bits: an ulp of 2^-10 at 1, ties to even
    t = torch.tensor([1.0 + 2**-12, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -0.1])
    tf32 = Precision("tf32", "cpu").rnd(t)
    assert tf32[:3].tolist() == [1.0, 1.0, 1.0 + 2**-9]
    assert abs(float(tf32[3]) + 0.1) <= 2**-11 * 0.1
    fp8 = Precision("fp8", "cpu").rnd(torch.tensor([448.0, 1.0, 100.0]))
    assert fp8.tolist() == [448.0, 1.0, 96.0]
