"""``hcunet_tpu_torch.hcat``, the reference's driver surface on the port,
against the repository's ``hcat`` alias (the JAX package) on the same
seeded numpy inputs, on the CPU (``device="cpu"``).

What is held, and to what:

* the 8 import forms of the reference's drivers
  (``tests/test_reference_drivers.py::DRIVER_IMPORT_FORMS``), their
  ``hcat`` prefix rewritten to ``hcunet_tpu_torch.hcat``, resolve; every
  file of ``hcat/`` has a twin that exports its public names;
* ``loss``: the deterministic methods within 1e-6 relative of the JAX
  alias's (float32 sums in other orders), ``random`` equal to the port's
  ``train/losses.py`` with a generator seeded 0;
* ``r_unet``: the facades on the JAX facade's variables (carried across by
  ``utils/port_jax.py``) within 1e-5 of the JAX forward's scale, as
  ``test_torch_port_recurrent.py`` holds its float32 RDCNet;
* ``train_utils`` targets, ``pad_image_with_reflections``, the
  transforms and ``segment.pixel_vec_to_cell``: exactly;
* ``train.frcnn`` on the small backbone (width 8, 64 x 64, the set-up of
  ``test_torch_port_detection_train.py``), 1 epoch over 2 sections read by
  each package's ``Section``: each summed loss within that file's 1e-4
  relative.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

import hcat as jhcat
from hcat import loss as jloss
from hcat import r_unet as jr_unet
from hcat import segment as jsegment
from hcat import transforms as jtransforms
from hcat import utils as jutils
from hcat.train import train_utils as jtrain_utils
from hcunet_tpu import compat as jcompat
from hcunet_tpu_torch import compat
from hcunet_tpu_torch import hcat
from hcunet_tpu_torch.data.tiff import imwrite
from hcunet_tpu_torch.hcat import loss, r_unet, segment, transforms, utils
from hcunet_tpu_torch.hcat.train import train_utils
from hcunet_tpu_torch.train import losses as port_losses
from tests.test_reference_drivers import DRIVER_IMPORT_FORMS
from tests.test_torch_port_detection_train import IMAGE_HW, detector_pair
from tests.test_torch_port_recurrent import share_of_scale

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIAS_ROOT = os.path.join(REPO_ROOT, "hcat")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# --- the surface ---------------------------------------------------------------


def _port_form(form: str) -> str:
    return re.sub(r"\bhcat\b", "hcunet_tpu_torch.hcat", form)


@pytest.mark.parametrize("form", DRIVER_IMPORT_FORMS)
def test_driver_import_forms_resolve_on_the_port(form):
    scope = {}
    exec(compile(_port_form(form), "<driver import>", "exec"), scope)
    assert "hcat" not in _port_form(form).replace("hcunet_tpu_torch.hcat", "")
    for name, value in scope.items():
        module = getattr(value, "__module__", None) or getattr(value, "__name__", "")
        if name != "__builtins__" and isinstance(module, str):
            assert not module.startswith(("hcat", "hcunet_tpu.")), (name, module)


def _alias_modules() -> list:
    """Dotted names under ``hcat``, one per file of the alias."""
    out = []
    for root, _dirs, files in os.walk(ALIAS_ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), ALIAS_ROOT)[:-3].split(os.sep)
                out.append(".".join(p for p in rel if p != "__init__"))
    return sorted(out)


@pytest.mark.parametrize("name", _alias_modules())
def test_every_alias_module_has_a_twin_with_its_names(name):
    import importlib

    suffix = "." + name if name else ""
    jmod = importlib.import_module("hcat" + suffix)
    mod = importlib.import_module("hcunet_tpu_torch.hcat" + suffix)
    assert os.path.exists(mod.__file__)
    assert sorted(mod.__all__) == sorted(jmod.__all__)
    for n in jmod.__all__:
        assert hasattr(mod, n), n
        owner = getattr(getattr(mod, n), "__module__", None) or ""
        assert not owner.startswith(("hcat", "hcunet_tpu.")), (n, owner)


def test_top_level_is_the_facade():
    """The constants and the facade objects.  (``unet``/``rcnn`` are the
    facade's in a fresh interpreter, checked by
    ``test_torch_port_imports.py``: here the import forms above have bound
    the submodules again, as ``import hcat.unet`` does to the JAX alias.)"""
    assert hcat.analyze is compat.analyze is hcat.main.analyze
    assert hcat.__conectivity__ == jhcat.__conectivity__
    for name in jhcat.__all__:
        if name.startswith("__"):
            assert getattr(hcat, name) == getattr(jhcat, name), name
    assert hcat.r_unet.__name__ == "hcunet_tpu_torch.hcat.r_unet"


# --- loss ------------------------------------------------------------------------


def _loss_inputs(seed=0):
    """Channels-first logits ``[2, 1, 10, 9, 4]``; mask and pwl larger, as a
    valid-conv target is."""
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((2, 1, 10, 9, 4)).astype(np.float32)
    mask = (rng.random((2, 1, 12, 11, 5)) > 0.6).astype(np.float32)
    pwl = rng.random((2, 1, 12, 11, 5)).astype(np.float32) * 3
    return pred, mask, pwl


CASES = {
    "pixel": lambda m, p, k, w: m.cross_entropy(p, k, w, method="pixel"),
    "pixel_no_pwl": lambda m, p, k, w: m.cross_entropy(p, k, method="pixel"),
    "worst_z": lambda m, p, k, w: m.cross_entropy(p, k, w, method="worst_z"),
    "sigmoid": lambda m, p, k, w: m.cross_entropy(p, k, w, method="sigmoid"),
    "dice": lambda m, p, k, w: m.dice(p, k),
    "l1": lambda m, p, k, w: m.L1Loss(p, k),
    "mse": lambda m, p, k, w: m.MSELoss(p, k),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax_alias(case):
    """numpy and CPU tensors alike; a Python float within 1e-6 relative."""
    pred, mask, pwl = _loss_inputs()
    want = CASES[case](jloss, pred, mask, pwl)
    got_np = CASES[case](_CpuLoss, pred, mask, pwl)
    got_t = CASES[case](loss, *(torch.from_numpy(a) for a in (pred, mask, pwl)))
    for got in (got_np, got_t):
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)


class _CpuLoss:
    """``hcunet_tpu_torch.hcat.loss`` on numpy inputs, asked for the CPU."""

    cross_entropy = staticmethod(lambda *a, **k: loss.cross_entropy(*a, device="cpu", **k))
    dice = staticmethod(lambda *a: loss.dice(*a, device="cpu"))
    L1Loss = staticmethod(lambda *a: loss.L1Loss(*a, device="cpu"))
    MSELoss = staticmethod(lambda *a: loss.MSELoss(*a, device="cpu"))


def test_loss_random_is_the_ports_with_generator_seeded_0():
    pred, mask, pwl = _loss_inputs(1)
    got = loss.cross_entropy(torch.from_numpy(pred), mask, pwl, method="random",
                             num_random_pixels=50)
    want = port_losses.cross_entropy(
        torch.from_numpy(np.moveaxis(pred, 1, -1)), np.moveaxis(mask, 1, -1),
        np.moveaxis(pwl, 1, -1), method="random", num_random_pixels=50,
        generator=torch.Generator().manual_seed(0))
    assert got == float(want)
    with pytest.raises(ValueError, match="num_random_pixels"):
        loss.cross_entropy(torch.from_numpy(pred), mask, method="random")


# --- r_unet ----------------------------------------------------------------------

RUNET_X = (1, 4, 16, 16, 5)
RDCNET_X = (1, 4, 16, 16, 10)


@pytest.mark.parametrize("family", ["RecursiveUnet", "RDCNet"])
def test_r_unet_facade_matches_jax_facade(family):
    """The JAX facade's variables (from its lazy init) carried into the
    port's facade: forwards within 1e-5 of the scale, and the tree read
    back equal."""
    shape = RUNET_X if family == "RecursiveUnet" else RDCNET_X
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jfac = getattr(jr_unet, family)()
    want = jfac.forward(x)
    fac = getattr(r_unet, family)(device="cpu")
    fac.variables = jax.tree.map(np.asarray, jfac.variables)
    got = fac(torch.from_numpy(x))
    assert got.shape == want.shape == (shape[0], 5, *shape[2:])
    assert share_of_scale(got, want) <= 1e-5
    back = jax.tree.map(np.asarray, fac.variables)
    assert jax.tree.structure(back) == jax.tree.structure(jfac.variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jfac.variables)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("family", ["RecursiveUnet", "RDCNet"])
def test_r_unet_facade_seeds_moves_and_serves_only(family):
    """The seed draws the weights (same seed, same weights); ``.to``
    moves the model; ``train(True)`` raises as in the JAX facade."""
    a = getattr(r_unet, family)(device="cpu")
    b = getattr(r_unet, family)(seed=0, device="cpu")
    c = getattr(r_unet, family)(seed=1, device="cpu")
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert a.cpu() is a and a.device.type == "cpu"
    assert a.eval() is a and a.train(False) is a
    assert a.to("meta") is a and a.device.type == "meta"
    assert {p.device.type for p in a.model.parameters()} == {"meta"}
    with pytest.raises(ValueError, match="serves inference"):
        a.train()
    with pytest.raises(ValueError):
        getattr(jr_unet, family)().train()
    assert r_unet.StackedDilation.__module__ == "hcunet_tpu_torch.models.rdcnet"


@pytest.mark.parametrize("entry", ["RecursiveUnet", "RDCNet", "loss"])
def test_facade_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    pred, mask, _pwl = _loss_inputs()
    calls = {
        "RecursiveUnet": lambda **kw: r_unet.RecursiveUnet(**kw),
        "RDCNet": lambda **kw: r_unet.RDCNet(**kw),
        "loss": lambda **kw: loss.dice(pred, mask, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](device="cuda")
    calls[entry](device="cpu")  # the CPU only when asked for


# --- utils, transforms, segment, train_utils -------------------------------------


@pytest.mark.parametrize("pad", [(30, 30, 6), (4, 2, 2)], ids=str)
def test_pad_image_with_reflections_matches_jax_alias(pad):
    """numpy in, numpy out; a tensor in, a tensor out, on its device."""
    x = np.random.default_rng(3).standard_normal((1, 3, 34, 31, 7)).astype(np.float32)
    want = jutils.pad_image_with_reflections(x, pad)
    got = utils.pad_image_with_reflections(x, pad)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    got_t = utils.pad_image_with_reflections(torch.from_numpy(x), pad)
    assert isinstance(got_t, torch.Tensor) and got_t.device.type == "cpu"
    np.testing.assert_array_equal(got_t.numpy(), want)
    with pytest.raises(ValueError, match="divisible by 2"):
        utils.pad_image_with_reflections(x, (3, 2, 2))


def _color_mask(seed=0):
    """A color-coded instance export ``[Z, Y, X, 3]`` uint8: boxes of
    distinct colors, some touching."""
    rng = np.random.default_rng(seed)
    vol = np.zeros((4, 28, 26, 3), np.uint8)
    for _ in range(7):
        z0, y0, x0 = rng.integers(0, 2), rng.integers(0, 20), rng.integers(0, 18)
        vol[z0:z0 + 3, y0:y0 + rng.integers(4, 9), x0:x0 + rng.integers(4, 9)] = (
            rng.integers(20, 255, 3))
    return vol


@pytest.mark.parametrize("target", ["makePWL", "makeMask", "makeMask_erosion",
                                    "CalculateCenterOfMass", "VectorToCenter",
                                    "colormask_to_mask"])
def test_train_utils_targets_equal_jax_alias(target):
    vol = _color_mask()

    def run(tu):
        if target == "makePWL":
            return [tu.makePWL()(vol)]
        if target.startswith("makeMask"):
            return [tu.makeMask(erosion=target.endswith("erosion"))(vol)]
        if target == "colormask_to_mask":
            return [tu.colormask_to_mask(vol), tu.colors_to_labels(vol)]
        centers, labels = tu.CalculateCenterOfMass()(vol)
        if target == "CalculateCenterOfMass":
            return [centers, labels]
        return [tu.VectorToCenter()(centers, labels)]

    for got, want in zip(run(train_utils), run(jtrain_utils), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_transforms_alias_equals_jax_alias(tmp_path):
    """``to_tensor`` and the path-built ``add_junk_image`` give the same
    arrays and boxes from the same generator."""
    rng = np.random.default_rng(4)
    for i in range(2):
        imwrite(str(tmp_path / f"junk{i}.tif"), rng.integers(0, 255, (40, 36, 3), np.uint8))
    image = rng.random((60, 56, 3)).astype(np.float32)
    boxes = [[5, 5, 15, 15], [30, 30, 50, 40], [2, 40, 12, 50]]
    labels = [1, 2, 1]
    np.testing.assert_array_equal(transforms.to_tensor()(image), jtransforms.to_tensor()(image))
    kw = dict(channel_index=(0, 1, 2), junk_image_size=(20, 20))
    got = transforms.add_junk_image(str(tmp_path), **kw)(image, boxes, labels,
                                                         np.random.default_rng(5))
    want = jtransforms.add_junk_image(str(tmp_path), **kw)(image, boxes, labels,
                                                           np.random.default_rng(5))
    np.testing.assert_array_equal(got[0], want[0])
    assert [list(b) for b in got[1]] == [list(b) for b in want[1]] and got[2] == want[2]


@pytest.mark.parametrize("layout", ["torch5d", "cf4d", "cl4d"])
def test_segment_pixel_vec_to_cell_equals_jax_alias(layout):
    from tests.test_torch_port_recurrent import _vector_field

    vec, prob = _vector_field(shape=(24, 22, 6))  # [X, Y, Z, 3], [X, Y, Z]
    arg = {"torch5d": np.moveaxis(vec, -1, 0)[None], "cf4d": np.moveaxis(vec, -1, 0),
           "cl4d": vec}[layout]
    want = jsegment.pixel_vec_to_cell(arg, prob[None, None], num_peaks=20)
    got = segment.pixel_vec_to_cell(torch.from_numpy(np.ascontiguousarray(arg)),
                                    torch.from_numpy(prob)[None, None], num_peaks=20)
    np.testing.assert_array_equal(got, want)


# --- train.frcnn -----------------------------------------------------------------

BOXES = [np.asarray([[4, 4, 20, 22], [30, 10, 50, 30], [10, 40, 28, 60]], np.float32),
         np.asarray([[8, 6, 26, 24], [36, 36, 56, 58]], np.float32)]
LABELS = [["OHC1", "OHC2", "OHC1"], ["OHC2", "OHC1"]]


def _write_sections(root) -> None:
    """Two sections, ``s<i>.tif`` (uint8 RGB, ``IMAGE_HW``) and ``s<i>.xml``
    (VOC boxes)."""
    rng = np.random.default_rng(6)
    for i, (boxes, names) in enumerate(zip(BOXES, LABELS)):
        img = rng.integers(0, 60, (*IMAGE_HW, 3)).astype(np.uint8)
        for (x1, y1, x2, y2), n in zip(boxes.astype(int), names):
            img[y1:y2, x1:x2] = (200, 120 if n == "OHC1" else 40, 80)
        imwrite(str(root / f"s{i}.tif"), img)
        objects = "".join(
            f"<object><name>{n}</name><bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
            f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>"
            for b, n in zip(boxes.astype(int), names))
        (root / f"s{i}.xml").write_text(f"<annotation>{objects}</annotation>")


def test_frcnn_matches_jax_alias(tmp_path):
    """One epoch over 2 sections at lr 1e-4: the per-epoch summed losses
    within 1e-4 relative; the facade keeps the trained weights."""
    _write_sections(tmp_path)
    jdet, variables, tdet = detector_pair()
    jmodel = jcompat._CompatRCNN(jdet, variables)
    model = compat._CompatRCNN(tdet)
    before = {k: v.clone() for k, v in tdet.state_dict().items()}
    kw = dict(epochs=1, lr=1e-4, gamma=0.5, scale=1.0)
    jds = jhcat.dataloader.Section(str(tmp_path), image_transforms=[jtransforms.to_float()])
    ds = hcat.dataloader.Section(str(tmp_path), image_transforms=[transforms.to_float()])
    _jm, want = jhcat.train.frcnn(jmodel, jds, optimizer=None, scheduler=None, **kw)
    got_model, got = hcat.train.frcnn(model, ds, optimizer="ignored", scheduler="ignored",
                                      device="cpu", **kw)
    assert got_model is model and model.detector is tdet
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert np.isfinite(g) and abs(g - w) <= 1e-4 * abs(w), (got, want)
    after = tdet.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
