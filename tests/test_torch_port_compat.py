"""The port's ``hcat`` facade (``hcunet_tpu_torch/compat.py``) against the
JAX facade (``hcunet_tpu/compat.py``) on the same weights: the twins of
``tests/test_compat.py``'s constants, layout, train-mode, save/load,
reference ``.unet`` blob, segmentation, detector-contract, segment-chain
and guard tests, on the CPU (``device="cpu"``).

The U-Net is the reference-spelled two-level net of ``tests/test_compat.py``
(``TINY_KW``) with the weights of ``test_torch_port_validate.py::blob_unet``
(random from a seed, its map following the blobs); the detector is the
small-backbone one of ``test_torch_port_detection.py``; both reach the two
facades through checkpoint files.  Tolerances: outputs within 5e-5 (the
float32 U-Net; in train mode, whose batch statistics sum in another order,
1e-4 of the output's and the statistics' scale), 1e-4 for the blurred
pipeline mask, detections as in
``test_torch_port_detection.py`` (boxes 1e-3 px, scores 1e-5), and the
instance stage exact given the same inputs.
"""

import pickle

import numpy as np
import pytest
import torch

from hcunet_tpu import compat as jcompat
from hcunet_tpu.benchmarks import _blob_scene
from hcunet_tpu.config import DetectorConfig as JaxDetectorConfig
from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.config import WatershedConfig as JaxWatershedConfig
from hcunet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from hcunet_tpu_torch import compat
from hcunet_tpu_torch.config import DetectorConfig, TileConfig, WatershedConfig
from hcunet_tpu_torch.models.unet import init_unet

from test_torch_port_detection import CFG as DET_CFG
from test_torch_port_detection import _detectors
from test_torch_port_validate import blob_unet

TINY_KW = dict(
    image_dimensions=3,
    in_channels=4,
    out_channels=1,
    feature_sizes=[8, 16],
    kernel={"conv1": (3, 3, 2), "conv2": (3, 3, 1)},
    upsample_kernel=(4, 4, 2),
    max_pool_kernel=(2, 2, 1),
    upsample_stride=(2, 2, 1),
    dilation=1,
    groups=1,
)
TILES = dict(eval_size=(48, 48, 6), pad=(24, 24, 3), batch=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A U-Net and a detector checkpoint written by the JAX package."""
    root = tmp_path_factory.mktemp("compat")
    jm = jcompat.unet(**TINY_KW)
    _cfg, _jmodel, variables = blob_unet()
    unet = str(root / "unet.hcunet")
    jax_save_checkpoint(unet, variables, jm.config, hyperparameters={"epochs": 3},
                        snapshot_sources=False)
    _jdet, det_vars, _tdet = _detectors("small")
    det = str(root / "det.hcunet")
    jax_save_checkpoint(det, det_vars, JaxDetectorConfig(**DET_CFG), snapshot_sources=False)
    return {"unet": unet, "det": det}


def _unets(files):
    """(the JAX facade's unet, the port's) on the same weights."""
    jm, tm = jcompat.unet(**TINY_KW), compat.unet(**TINY_KW, device="cpu")
    assert jm.load(files["unet"]) == tm.load(files["unet"]) == {"epochs": 3}
    return jm, tm


def _rcnns(files):
    return (jcompat.rcnn(files["det"], config=JaxDetectorConfig(**DET_CFG), backbone="small"),
            compat.rcnn(files["det"], config=DetectorConfig(**DET_CFG), backbone="small",
                        device="cpu"))


def test_compat_constants_match_jax():
    for name in ("__conectivity__", "__compactness__", "__expand_mask__", "__expand_z__",
                 "__z_tolerance__", "__mask_prob_threshold__", "__cell_prob_threshold__"):
        assert getattr(compat, name) == getattr(jcompat, name), name
    assert set(compat.__all__) == set(jcompat.__all__)
    assert (compat.__conectivity__, compat.__expand_mask__, compat.__cell_prob_threshold__) == (
        1, 15, 0.25)


def test_compat_unet_forward_torch_layout(files):
    jm, tm = _unets(files)
    x = np.random.default_rng(0).standard_normal((1, 4, 48, 48, 6)).astype(np.float32)
    out = tm(x)
    with torch.no_grad():
        direct = tm.model(torch.from_numpy(np.moveaxis(x, 1, -1).copy())).numpy()
    np.testing.assert_array_equal(out, np.moveaxis(direct, -1, 1))
    np.testing.assert_allclose(out, jm(x), atol=5e-5, rtol=0)
    assert out.shape == (1, 1, 34, 34, 4)
    assert isinstance(tm(torch.from_numpy(x)), np.ndarray)


def test_compat_unet_train_mode_updates_batch_stats(files):
    jm, tm = _unets(files)
    x = np.random.default_rng(1).standard_normal((1, 4, 48, 48, 6)).astype(np.float32) + 3.0
    before = tm.variables["batch_stats"]["down0"]["ConvBNRelu_0"]["BatchNorm_0"]["mean"].copy()
    want_out = jm.train()(x)
    # train-mode statistics are float32 sums over the batch, in another order
    # on each side: the output within 1e-4 of its scale
    np.testing.assert_allclose(tm.train()(x), want_out,
                               atol=1e-4 * float(np.abs(want_out).max()), rtol=0)
    got, want = tm.variables["batch_stats"], jm.variables["batch_stats"]
    assert not np.allclose(got["down0"]["ConvBNRelu_0"]["BatchNorm_0"]["mean"], before)
    for block in want:
        for conv in want[block]:
            for k in ("mean", "var"):
                w = np.asarray(want[block][conv]["BatchNorm_0"][k])
                g = got[block][conv]["BatchNorm_0"][k]
                np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, float(np.abs(w).max())),
                                           rtol=0, err_msg=f"{block}/{conv}/{k}")
    tm.eval()
    assert tm._training is False and not tm.model.training


def test_compat_unet_save_load_roundtrip(tmp_path, files):
    jm, tm = _unets(files)
    path = str(tmp_path / "model.unet")
    tm.save(path, hyperparameters={"epochs": 7, "lr": 1e-3})
    t2 = compat.unet(**TINY_KW, seed=99, device="cpu")  # another init, then restored
    assert t2.load(path) == {"epochs": 7, "lr": 1e-3}
    j2 = jcompat.unet(**TINY_KW, seed=99)
    assert j2.load(path) == {"epochs": 7, "lr": 1e-3}  # the JAX facade reads it too
    x = np.random.default_rng(2).standard_normal((1, 4, 48, 48, 6)).astype(np.float32)
    np.testing.assert_array_equal(t2(x), tm(x))
    np.testing.assert_allclose(j2(x), jm(x), atol=1e-6, rtol=0)
    for k, v in tm.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[k], v), k


def test_compat_unet_loads_reference_dot_unet_blob(tmp_path):
    """A reference ``.unet`` file (``torch.save`` of ``{'state_dict',
    'model_specifications', 'hyperparameters'}``, ``hcat/unet.py:145-165``)
    written from the port's UNet, whose state dict keeps the reference's
    names: both facades load it, with the reference's skip behaviour on,
    and give the same forward."""
    ref = compat.unet(**TINY_KW, device="cpu")
    cfg = compat._reference_unet_config(dict(TINY_KW))
    model = init_unet(cfg, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
    path = str(tmp_path / "ref.unet")
    torch.save({"state_dict": model.state_dict(), "model_specifications": dict(TINY_KW),
                "hyperparameters": {"epochs": 123}}, path)
    jm = jcompat.unet(**TINY_KW)
    assert ref.load(path) == jm.load(path) == {"epochs": 123}
    assert ref.config.reference_skip_bug and jm.config.reference_skip_bug
    for k, v in model.state_dict().items():
        assert torch.equal(ref.model.state_dict()[k], v), k
    x = torch.randn((1, 4, 48, 48, 6), generator=gen)
    with torch.no_grad():
        want = model(x.movedim(1, -1)).movedim(-1, 1).numpy()
    np.testing.assert_array_equal(ref(x.numpy()), want)
    np.testing.assert_allclose(jm(x.numpy()), want, atol=5e-5, rtol=0)


def _image(shape=(64, 64, 6)):
    vol, _ = _blob_scene(*shape, n_cells=12 if shape[0] > 64 else 4, seed=0)
    norm = (vol.astype(np.float32) / np.float32(65536) - np.float32(0.5)) / np.float32(0.5)
    return vol, np.moveaxis(norm, -1, 0)[None]  # [1, C, X, Y, Z]


def test_compat_predict_segmentation_mask_layouts(files):
    jm, tm = _unets(files)
    _vol, image = _image()
    kw = dict(use_probability_map=True)
    prob = compat.predict_segmentation_mask(tm, image, tile_cfg=TileConfig(**TILES), **kw)
    jprob = jcompat.predict_segmentation_mask(jm, image, tile_cfg=JaxTileConfig(**TILES), **kw)
    assert prob.shape == jprob.shape == (1, 1, 64, 64, 6) and prob.dtype == np.float32
    np.testing.assert_allclose(prob, jprob, atol=5e-5, rtol=0)
    hard = compat.predict_segmentation_mask(tm, image, "cpu", tile_cfg=TileConfig(**TILES))
    assert hard.dtype == np.uint8
    np.testing.assert_array_equal(hard[0, 0], prob[0, 0] > 0.5)


def test_compat_rcnn_torchvision_contract(files, monkeypatch):
    jr, tr = _rcnns(files)
    images = np.random.default_rng(3).random((2, 3, 112, 128)).astype(np.float32)
    got, want = tr.eval()(images), jr(images)
    assert isinstance(got, list) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == {"boxes", "labels", "scores"}
        assert g["boxes"].shape == (len(g["scores"]), 4) and g["labels"].dtype == np.int64
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5, rtol=0)
    assert sum(len(g["scores"]) for g in got) > 0
    with pytest.raises(ValueError):
        tr.train()  # an inference facade
    assert tr.cpu() is tr and tr.to("cpu") is tr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.cuda()  # a real move, never a quiet no-op
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compat.unet(**TINY_KW)  # CUDA unless the caller names the CPU


def test_compat_segment_chain_and_analyze(tmp_path, files, monkeypatch):
    """The facade chained the way ``hcat/main.py:83-194`` chains it, then the
    one-call ``analyze``, against the JAX facade."""
    monkeypatch.chdir(tmp_path)  # analyze writes ./all_cells.pkl (main.py:219)
    jm, tm = _unets(files)
    jr, tr = _rcnns(files)
    vol, image = _image((96, 96, 6))

    cands = compat.predict_cell_candidates(image[:, [0, 2, 3]], tr)
    jcands = jcompat.predict_cell_candidates(image[:, [0, 2, 3]], jr)
    assert set(cands) == set(jcands) >= {"boxes", "scores", "labels", "z_level"}
    assert len(cands["scores"]) == len(jcands["scores"]) > 0
    np.testing.assert_allclose(cands["boxes"], jcands["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(cands["scores"], jcands["scores"], atol=1e-5, rtol=0)
    merged = compat.predict_cell_candidates(image[:, [0, 2, 3]], tr, candidate_list=cands)
    jmerged = jcompat.predict_cell_candidates(image[:, [0, 2, 3]], jr, candidate_list=jcands)
    assert len(merged["scores"]) == len(jmerged["scores"])

    jprob = jcompat.predict_segmentation_mask(jm, image, use_probability_map=True,
                                              tile_cfg=JaxTileConfig(**TILES))
    unique_mask, seed = compat.generate_unique_segmentation_mask_from_probability(
        jprob, jcands, image)
    jmask, jseed = jcompat.generate_unique_segmentation_mask_from_probability(
        jprob, jcands, image)
    np.testing.assert_array_equal(unique_mask, jmask)
    np.testing.assert_array_equal(seed, jseed)
    assert unique_mask.shape == (96, 96, 6)
    cells = compat.generate_cell_objects(image, unique_mask)
    jcells = jcompat.generate_cell_objects(image, jmask)
    assert [(c.unique_id, c.center, c.volume) for c in cells] == [
        (c.unique_id, c.center, c.volume) for c in jcells]

    kw = dict(volume=vol, numchunks=3, fit_cochlea=False)
    mask, uniq, cell_list = compat.analyze(
        path_chunk_storage=str(tmp_path / "port"), unet_model=tm, faster_rcnn=tr,
        tiles=TileConfig(**TILES), watershed=WatershedConfig(expand_mask=2), **kw)
    with open(tmp_path / "all_cells.pkl", "rb") as f:
        assert len(pickle.load(f)) == len(cell_list)
    jmask_, juniq, jcell_list = jcompat.analyze(
        path_chunk_storage=str(tmp_path / "jax"), unet_model=jm, faster_rcnn=jr,
        tiles=JaxTileConfig(**TILES), watershed=JaxWatershedConfig(expand_mask=2),
        write_all_cells_pkl=False, **kw)
    assert mask.shape == uniq.shape == (1, 1, 96, 96, 6)
    np.testing.assert_allclose(mask, jmask_, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(uniq, juniq)
    assert len(cell_list) == len(jcell_list) > 0
    assert [(c.unique_id, c.center, c.volume) for c in cell_list] == [
        (c.unique_id, c.center, c.volume) for c in jcell_list]


def test_compat_analyze_guards():
    with pytest.raises(NotADirectoryError):
        compat.analyze(volume=np.zeros((8, 8, 4, 4)))  # main.py:22-23
    with pytest.raises(ValueError, match="unet_model"):
        compat.analyze(volume=np.zeros((8, 8, 4, 4)), path_chunk_storage="/tmp")
