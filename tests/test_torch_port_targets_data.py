"""The port's training targets, transforms and datasets against the JAX
package's (``hcunet_tpu/train/targets.py``, ``data/transforms.py``,
``data/datasets.py``).  Both are numpy/scipy code drawing from an explicit
``np.random.Generator``, so the same inputs and the same generator seed must
give identical arrays."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.data import datasets as jds
from hcunet_tpu.data import transforms as jt
from hcunet_tpu.train import targets as jtg
from hcunet_tpu_torch.data import datasets as tds
from hcunet_tpu_torch.data import transforms as tt
from hcunet_tpu_torch.train import targets as ttg


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _color_cells(seed=0, shape=(3, 24, 28)):
    """An RGB instance export [Z, Y, X, 3]: a background color and touching
    cells of distinct colors."""
    rng = np.random.default_rng(seed)
    img = np.zeros((*shape, 3), np.uint8)
    img[...] = (10, 20, 30)
    for i, (y, x) in enumerate([(6, 6), (6, 13), (16, 10), (15, 21)]):
        img[:, y - 4 : y + 4, x - 4 : x + 4] = rng.integers(40, 255, 3)
    return img


@pytest.mark.parametrize(
    "fn", ["colors_to_labels", "make_pwl", "make_pwl_ray_march", "make_mask",
           "center_of_mass_target"],
)
def test_targets_match_jax(fn):
    img = _color_cells()
    _same(getattr(ttg, fn)(img), getattr(jtg, fn)(img))


def test_vector_to_center_and_preprocess_match_jax(tmp_path):
    img = _color_cells(1)
    centers, labels = jtg.center_of_mass_target(jtg.make_mask(img))
    _same(ttg.vector_to_center(centers, labels), jtg.vector_to_center(centers, labels))
    outs = []
    for pkg, name in ((ttg, "port"), (jtg, "jax")):
        d = tmp_path / name
        d.mkdir()
        np.save(d / "cell.npy", img)
        outs.append(pkg.preprocess_volume(str(d / "cell.npy")))
        with open(d / "cell.labels.vector.pkl", "rb") as f:
            outs.append(pickle.load(f))
    _same(outs[0], outs[2])
    _same(outs[1], outs[3])


def _vol(seed=0, shape=(20, 18, 6, 4)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


IMAGE_TRANSFORMS = {
    "spekle": lambda m: m.spekle(0.1),
    "random_gamma": lambda m: m.random_gamma((0.8, 1.2)),
    "normalize": lambda m: m.normalize([0.5, 0.4, 0.3, 0.2], [0.5, 0.6, 0.7, 0.8]),
    "drop_channel": lambda m: m.drop_channel(1.0),
    "random_intensity": lambda m: m.random_intensity((-30, 30), 0.7),
    "clean_image": lambda m: m.clean_image(),
    "remove_channel": lambda m: m.remove_channel((0, 2, 3)),
    "to_batch": lambda m: m.to_batch(),
    "reshape": lambda m: m.reshape(),
}


@pytest.mark.parametrize("name", list(IMAGE_TRANSFORMS))
def test_image_transforms_match_jax(name):
    img = _vol()
    img[0, 0, 0, 0] = np.nan
    if name != "clean_image":
        img = np.nan_to_num(img)
    got = IMAGE_TRANSFORMS[name](tt)(img.copy(), np.random.default_rng(5))
    want = IMAGE_TRANSFORMS[name](jt)(img.copy(), np.random.default_rng(5))
    _same(got, want)


JOINT_TRANSFORMS = {
    "random_crop": lambda m: m.random_crop((12, 10, 4)),
    "elastic_deform": lambda m: m.elastic_deform((3, 3, 3), 2.0),
    "random_affine": lambda m: m.random_affine(0.2),
    "random_rotate": lambda m: m.random_rotate(),
    "nul_crop": lambda m: m.nul_crop(1.0),
}


@pytest.mark.parametrize("name", list(JOINT_TRANSFORMS))
def test_joint_transforms_match_jax(name):
    """The ``train-unet`` recipe's joint transforms on [image, mask, pwl]:
    the same generator seed, the same arrays in both packages."""
    image = _vol(1)
    mask = np.zeros((20, 18, 6, 1), np.float32)
    mask[4:15, 3:12] = 1.0
    pwl = _vol(2, (20, 18, 6, 1))
    got = JOINT_TRANSFORMS[name](tt)([image, mask, pwl], np.random.default_rng(9))
    want = JOINT_TRANSFORMS[name](jt)([image, mask, pwl], np.random.default_rng(9))
    _same(got, want)


@pytest.mark.parametrize("name", ["random_x_flip", "random_y_flip", "random_resize", "add_junk_image"])
def test_detection_transforms_match_jax(name):
    image = _vol(3, (40, 36, 3))
    boxes = [[2, 3, 10, 12], [20, 5, 30, 16]]
    labels = [1, 2]
    make = {
        "random_x_flip": lambda m: m.random_x_flip(1.0),
        "random_y_flip": lambda m: m.random_y_flip(1.0),
        "random_resize": lambda m: m.random_resize(1.0, (0.8, 1.2)),
        "add_junk_image": lambda m: m.add_junk_image([_vol(4, (30, 30, 3))], (8, 8)),
    }[name]
    got = make(tt)(image.copy(), boxes, labels, rng=np.random.default_rng(2))
    want = make(jt)(image.copy(), boxes, labels, rng=np.random.default_rng(2))
    _same(got, want)


def test_to_float_distance_transform_and_device_normalize():
    u16 = np.random.default_rng(0).integers(0, 65535, (4, 5, 2), dtype=np.uint16)
    _same(tt.to_float()(u16), jt.to_float()(u16))
    assert tt.integer_unit_scale(np.uint8) == jt.integer_unit_scale(np.uint8) == 256.0
    mask = np.zeros((3, 16, 16), np.uint8)
    mask[:, 4:9, 5:12] = 1
    _same(tt.distance_transform(mask), jt.distance_transform(mask))
    img, mean, std = _vol(5, (6, 5, 4, 3)), (0.5, 0.4, 0.3), (0.2, 0.5, 0.6)
    got = tt.device_normalize(torch.from_numpy(img), mean, std)
    want = np.asarray(jt.device_normalize(jnp.asarray(img), mean, std))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.fixture
def stack_dir(tmp_path):
    """Two Stack samples (image, mask, pwl as .npy), with the
    RecursiveStack files, and one Section sample (xml + tif)."""
    rng = np.random.default_rng(0)
    for i in range(2):
        stem = tmp_path / f"s{i}"
        np.save(f"{stem}.npy", rng.random((20, 18, 6, 4)).astype(np.float32))
        m = np.zeros((20, 18, 6), np.float32)
        m[5:15, 4:12] = 1.0
        np.save(f"{stem}.mask.npy", m)
        np.save(f"{stem}.pwl.npy", rng.random((20, 18, 6)).astype(np.float32))
        from hcunet_tpu.data.tiff import imwrite

        imwrite(f"{stem}.labels.com.tif", (m * 3).astype(np.uint16))
        with open(f"{stem}.labels.vector.pkl", "wb") as f:
            pickle.dump(rng.random((20, 18, 6, 3)), f)
    from hcunet_tpu.data.tiff import imwrite

    imwrite(str(tmp_path / "sec.tif"), (rng.random((40, 36, 3)) * 255).astype(np.uint8))
    objects = "".join(
        f"<object><name>{n}</name><bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
        f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>"
        for n, b in (("OHC1", (2, 3, 10, 12)), ("IHC", (20, 5, 30, 16)))
    )
    (tmp_path / "sec.xml").write_text(f"<annotation>{objects}</annotation>")
    return str(tmp_path)


def test_datasets_match_jax(stack_dir):
    """``Stack``, ``RecursiveStack`` and ``Section`` with the recipe's
    transforms: the same samples for the same generator seed."""
    for name in ("Stack", "RecursiveStack"):
        kw = lambda m: dict(joint_transforms=[m.random_crop((12, 10, 4))],
                            image_transforms=[m.random_gamma(), m.drop_channel(0.5)])
        port, ref = getattr(tds, name)(stack_dir, **kw(tt)), getattr(jds, name)(stack_dir, **kw(jt))
        assert len(port) == len(ref) == 2
        for i in range(2):
            _same(port.__getitem__(i, np.random.default_rng(i)), ref.__getitem__(i, np.random.default_rng(i)))
    kw = lambda m: dict(joint_transforms=[m.random_x_flip(0.5)], simple_class=True)
    port, ref = tds.Section(stack_dir, **kw(tt)), jds.Section(stack_dir, **kw(jt))
    _same(port.__getitem__(0, np.random.default_rng(3)), ref.__getitem__(0, np.random.default_rng(3)))
    with pytest.raises(FileNotFoundError):
        tds.Stack(os.path.join(stack_dir, "missing"))
