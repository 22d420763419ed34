"""The port's validation layer (``hcunet_tpu_torch/analysis/validate.py``)
against the JAX package's ``hcunet_tpu/analysis/validate.py`` on the same
numpy inputs: the metrics and histograms exactly, the study aggregate's
rows, CSV and regression (floats within 1e-12), the legacy-pickle loader
with its two rejection paths, and ``validate_segmentation`` on a 2-sample
``.npy`` Stack with the same U-Net weights in both packages (dice and error
rates within 1e-6; thresholded masks equal except where the JAX
probability lies within 5e-5 of the threshold)."""

import io
import os
import pickle
import sys
import types

import jax
import numpy as np
import pytest
import torch

from hcunet_tpu.analysis import validate as jval
from hcunet_tpu.analysis.haircell import HairCell as JaxHairCell
from hcunet_tpu.benchmarks import _blob_scene
from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.data import transforms as jt
from hcunet_tpu.data.datasets import Stack as JaxStack
from hcunet_tpu.infer.compile import compile_serving_apply as jax_serving_apply
from hcunet_tpu.infer.tiling import predict_segmentation_mask as jax_predict
from hcunet_tpu_torch.analysis import validate as tval
from hcunet_tpu_torch.analysis.haircell import HairCell
from hcunet_tpu_torch.config import TileConfig
from hcunet_tpu_torch.data import transforms as tt
from hcunet_tpu_torch.data.datasets import Stack
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
from tests.torch_port_support import SMALL, jax_unet, port_unet

TILES = dict(eval_size=(48, 48, 6), pad=(24, 24, 3), batch=2)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    for shape in [(10, 10), (16, 12, 5)]:
        truth = rng.random(shape) > 0.6
        pred = rng.random(shape) > 0.5
        for a, b in ((pred, truth), (truth, truth), (np.zeros(shape), truth), (pred, np.zeros(shape))):
            assert tval.dice_score(a, b) == jval.dice_score(a, b)
            assert tval.pixel_error_rates(a, b) == jval.pixel_error_rates(a, b)
    truth = np.zeros((10, 10), bool)
    truth[2:8, 2:8] = True
    pred = np.zeros((10, 10), bool)
    pred[2:8, 2:5] = True
    assert tval.pixel_error_rates(pred, truth) == (0.5, 0.0)


def test_gfp_histograms_match_jax():
    rng = np.random.default_rng(1)
    img = rng.random((10, 10, 3, 4))
    m = rng.random((10, 10, 3)) > 0.5
    for channel, bins in ((1, 20), (0, 50)):
        got = tval.gfp_histograms(img, m, ~m, channel=channel, bins=bins)
        want = jval.gfp_histograms(img, m, ~m, channel=channel, bins=bins)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert got["auto"].shape == (50,) and got["edges"].shape == (51,)


@pytest.mark.parametrize("name", [
    "/data/Jul 18 AAV2-PHP.B-CMV m2 G80 L5 cochlea",
    "/data/Feb 6 Synapsin m11 G30 L0.5_cellBycell/",
    "plain_name",
    "Dec 1 smCBA AAV9 m3 G100 L12.5",
])
def test_parse_experiment_metadata_matches_jax(name):
    assert tval.parse_experiment_metadata(name) == jval.parse_experiment_metadata(name)


def _aggregates():
    out = []
    for mod, cls in ((tval, HairCell), (jval, JaxHairCell)):
        agg = mod.StudyAggregate()
        for gain, gfp in [(10, 1.0), (20, 2.1), (30, 2.9), (40, float("nan"))]:
            cells = []
            for i in range(3):
                c = cls([0, 0, 0, 1, 1, 1], [0, 0, 0], unique_id=i + 1)
                c.volume = 1e-16 * (i + 1)
                c.is_bad = i == 2 and gain == 20
                c.distance_from_apex = 0.1 * i
                c.signal_stats = {
                    "gfp": {"mean": gfp + 0.01 * i, "std": 0.1, "median": gfp},
                    "dapi": {"mean": 0.3, "std": 0.2, "median": 0.25},
                }
                c.gfp_stats = c.signal_stats["gfp"]
                cells.append(c)
            agg.add_image(f"/study/Feb 6 CMV m1 G{gain} L1", cells)
        out.append(agg)
    return out


def test_study_aggregate_matches_jax(tmp_path):
    got, want = _aggregates()
    np.testing.assert_equal(got.rows, want.rows)  # NaN equal to NaN
    assert len(got.rows) == 11  # one bad cell left out
    assert got.dataframe().to_csv(index=False) == want.dataframe().to_csv(index=False)
    reg, jreg = got.gfp_vs_gain_regression(), want.gfp_vs_gain_regression()
    assert reg.keys() == jreg.keys() and reg["n"] == jreg["n"] == 8
    for k in ("slope", "intercept", "r2"):
        assert abs(reg[k] - jreg[k]) <= 1e-12, k
    paths = got.save_figures(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["channel_boxplots.png", "gfp_vs_gain.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_load_legacy_cells_matches_jax(tmp_path):
    """A reference-era ``all_cells.pkl`` pickled under the historical
    ``haircell`` module, with torch-tensor statistics, through both
    loaders."""
    legacy = types.ModuleType("haircell")

    class HairCellRef:  # stand-in for the reference class being pickled
        pass

    HairCellRef.__module__ = "haircell"
    HairCellRef.__qualname__ = "HairCell"
    legacy.HairCell = HairCellRef
    sys.modules["haircell"] = legacy
    try:
        cells = []
        for i in range(2):
            c = HairCellRef()
            c.unique_id = 7 + i
            c.volume = 1.5e-16
            c.is_bad = False
            c.center = np.asarray([1.0, 2.0, 3.0])
            c.distance_from_apex = []
            c.signal_stats = {"gfp": {"mean": torch.tensor(0.5 + i), "std": torch.tensor(0.1),
                                      "median": 0.4}}
            c.gfp_stats = {"mean": torch.tensor(0.5)}
            cells.append(c)
        p = tmp_path / "all_cells.pkl"
        with open(p, "wb") as f:
            pickle.dump(cells, f)
    finally:
        del sys.modules["haircell"]
    got, want = tval.load_legacy_cells(str(p)), jval.load_legacy_cells(str(p))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.unique_id == w.unique_id and g.volume == w.volume
        assert g.signal_stats == w.signal_stats and g.gfp_stats == w.gfp_stats
        np.testing.assert_array_equal(g.center, w.center)
        assert isinstance(g.signal_stats["gfp"]["mean"], float)
    agg = tval.StudyAggregate()
    agg.add_image("/study/Feb 6 CMV m1 G10 L1", got)
    assert len(agg.rows) == 2


def test_load_legacy_cells_rejects_dangerous_globals(tmp_path):
    """A pickle that smuggles an executable global (``os.system``) raises
    instead of running on load."""

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    p = tmp_path / "all_cells.pkl"
    with open(p, "wb") as f:
        pickle.dump([Evil()], f)
    with pytest.raises(pickle.UnpicklingError, match="refusing to unpickle"):
        tval.load_legacy_cells(str(p))


def test_load_legacy_cells_blocks_nested_torch_load_gadget(tmp_path):
    """``torch.storage._load_from_bytes`` runs ``torch.load`` inside: the
    allowlisted entry must not hand the bytes to an unrestricted nested
    unpickler."""

    class _Evil:
        def __reduce__(self):
            return (eval, ("__import__('os').getcwd()",))

    evil_torch_bytes = io.BytesIO()
    torch.save({"payload": _Evil()}, evil_torch_bytes)

    class _Carrier:
        def __reduce__(self):
            import torch.storage

            return (torch.storage._load_from_bytes, (evil_torch_bytes.getvalue(),))

    p = tmp_path / "all_cells.pkl"
    with open(p, "wb") as f:
        pickle.dump([_Carrier()], f)
    with pytest.raises(pickle.UnpicklingError, match="[Ww]eights.only|eval"):
        tval.load_legacy_cells(str(p))


def write_npy_stack(root, n=2, shape=(64, 64, 6), n_cells=4, seed=0):
    """``n`` samples of the blob scene as ``X.npy`` / ``X.mask.npy`` /
    ``X.pwl.npy`` in the on-disk layout ([Z, Y, X, C] and [Z, Y, X]; the
    mask 0/255 as the reference's files are)."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        vol, prob = _blob_scene(*shape, n_cells=n_cells, seed=seed + i)
        np.save(os.path.join(root, f"s{i}.npy"), np.ascontiguousarray(vol.transpose(2, 1, 0, 3)))
        mask = np.where(prob > 0.3, 255, 0).astype(np.uint8)
        np.save(os.path.join(root, f"s{i}.mask.npy"), np.ascontiguousarray(mask.transpose(2, 1, 0)))
        np.save(os.path.join(root, f"s{i}.pwl.npy"),
                np.ascontiguousarray(prob.transpose(2, 1, 0)))


def blob_unet():
    """The ``SMALL`` net with random weights from a seed, its output conv
    negated and scaled by 10 so that its map follows the scene's blobs (as
    in ``tests/test_torch_port_pipeline.py``): ``(config, JAX model, JAX
    variables)``."""
    cfg, jmodel, variables = jax_unet(SMALL, (48, 48, 6))
    params = dict(variables["params"])
    params["out_kernel"] = params["out_kernel"] * np.float32(-10)
    params["out_bias"] = params["out_bias"] * np.float32(-10)
    return cfg, jmodel, {"params": params, "batch_stats": variables["batch_stats"]}


def assert_validation_close(got, want, got_masks, want_probs, threshold):
    """The port's ``validate_segmentation`` summary against JAX's: masks
    equal except at voxels whose JAX probability lies within 5e-5 of the
    threshold; then dice and error rates within 1e-6, or within what the
    differing voxels can move them."""
    assert len(got) == len(want)
    for g, w, mask, prob in zip(got, want, got_masks, want_probs):
        differ = mask != (prob > threshold)
        assert not (differ & (np.abs(prob - threshold) > 5e-5)).any()
        slack = 1e-6 + 4 * int(differ.sum()) / max(int(mask.sum()), 1)
        assert g["index"] == w["index"]
        for k in ("dice", "missed_ratio", "false_ratio"):
            assert abs(g[k] - w[k]) <= slack, (k, g[k], w[k])


def test_validate_segmentation_matches_jax(tmp_path):
    root = str(tmp_path / "stack")
    write_npy_stack(root)
    cfg, jmodel, variables = blob_unet()
    jds = JaxStack(root, joint_transforms=[jt.to_float(), jt.reshape()],
                   image_transforms=[jt.normalize()])
    tds = Stack(root, joint_transforms=[tt.to_float(), tt.reshape()],
                image_transforms=[tt.normalize()])
    japply = jax.tree_util.Partial(jax_serving_apply(jmodel, variables, dtype=jax.numpy.float32))
    tapply = compile_serving_apply(port_unet(cfg, variables), dtype=torch.float32, device="cpu")
    want = jval.validate_segmentation(japply, jds, cfg, JaxTileConfig(**TILES), threshold=0.5)
    got = tval.validate_segmentation(tapply, tds, cfg, TileConfig(**TILES), threshold=0.5,
                                     device="cpu")
    probs, masks = [], []
    for i in range(2):
        image = tds[i][0]
        np.testing.assert_array_equal(image, jds[i][0])
        probs.append(np.asarray(jax_predict(japply, jax.numpy.asarray(image), cfg,
                                            JaxTileConfig(**TILES),
                                            use_probability_map=True))[0, ..., 0])
        masks.append(predict_segmentation_mask(tapply, image, cfg, TileConfig(**TILES),
                                               use_probability_map=True, device="cpu")
                     .numpy()[0, ..., 0] > 0.5)
        assert 0.05 < masks[-1].mean() < 0.95  # a map with both sides of the threshold
    assert_validation_close(got, want, masks, probs, 0.5)
    for g, w in zip(got, want):
        for k in ("auto", "manual", "edges"):
            assert g["hist"][k].shape == w["hist"][k].shape
