"""The port's host tail against the JAX package's: the chunk store
(``infer/chunks.py``), cell objects (``analysis/haircell.py``), the cochlear
fit (``analysis/cochlea.py``) and the CSV (``analysis/export.py``).

All of it is the same numpy/scipy arithmetic on both sides, so results must
be equal exactly: arrays bit for bit, cell statistics as the same floats,
the CSV byte for byte (the port writes it with the ``csv`` module, the JAX
package with pandas).
"""

import math
import os

import numpy as np
import pytest

from hcunet_tpu.analysis import cochlea as jcochlea
from hcunet_tpu.analysis import export as jexport
from hcunet_tpu.analysis import haircell as jhaircell
from hcunet_tpu.infer import chunks as jchunks
from hcunet_tpu_torch.analysis import cochlea as tcochlea
from hcunet_tpu_torch.analysis import export as texport
from hcunet_tpu_torch.analysis import haircell as thaircell
from hcunet_tpu_torch.data import tiff as ttiff
from hcunet_tpu_torch.data import transforms as ttransforms
from hcunet_tpu_torch.infer import chunks as tchunks


def _parts(kind, rng):
    """``[(mask, labels, loc, mask_scale)]`` of one kind of spill."""
    shape = (9, 7, 3)
    out = []
    for i, loc in enumerate([(0, 0), (9, 0), (0, 7), (9, 7)]):
        seg = np.zeros(shape, np.int32)
        seg[2 : 4 + i % 2, 3:5, :] = i + 1
        scale = None
        if kind == "quantized":
            mask = rng.integers(0, 65536, size=shape).astype(np.uint16)
            scale = 10.0 / 65535.0
        elif kind == "null" and i % 2:
            mask, seg = np.zeros(shape, np.float32), np.zeros(shape, np.int32)
        elif kind == "int64_overflow":
            mask = np.full(shape, 0.5, np.float32)
            seg = np.where(seg > 0, 2**30 + i, 0).astype(np.int64)
        else:
            mask = rng.random(shape).astype(np.float32)
        out.append((mask, seg, loc, scale))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", ["plain", "null", "compressed", "quantized", "int64_overflow"])
def test_spills_reconstruct_the_same_in_both_packages(tmp_path, kind, writer):
    """Parts spilled by one package reconstruct identically in the other,
    and the port's ``Part`` round trips."""
    rng = np.random.default_rng(1)
    mod = tchunks if writer == "port" else jchunks
    parts = _parts(kind, rng)
    for i, (mask, seg, loc, scale) in enumerate(parts):
        p = mod.Part.create(mask, seg, loc, mask_scale=scale)
        p.save(str(tmp_path / f"p{i}{mod.PART_EXT}"), compress=kind == "compressed")
    back = tchunks.Part.load(str(tmp_path / f"p0{tchunks.PART_EXT}"))
    want0 = jchunks.Part.load(str(tmp_path / f"p0{jchunks.PART_EXT}"))
    np.testing.assert_array_equal(back.dense_mask(), want0.dense_mask())
    np.testing.assert_array_equal(back.dense_segmented(), want0.dense_segmented())
    assert (back.loc, back.shape, back.mask_dtype, back.mask_scale) == (
        want0.loc, want0.shape, want0.mask_dtype, want0.mask_scale
    )

    mask, seg = tchunks.reconstruct(str(tmp_path))
    jmask, jseg = jchunks.reconstruct(str(tmp_path))
    assert mask.dtype == jmask.dtype and seg.dtype == jseg.dtype
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_array_equal(mask, tchunks.reconstruct_mask(str(tmp_path)))
    np.testing.assert_array_equal(seg, tchunks.reconstruct_segmented(str(tmp_path)))
    if kind == "quantized":
        dq = parts[0][0].astype(np.float32)
        dq *= np.float32(parts[0][3])
        np.testing.assert_array_equal(mask[:9, :7], dq)  # bit-identical dequantize
    if kind == "null":
        assert not mask[9:, :7].any() and not seg[9:, :7].any()
    if kind == "int64_overflow":
        assert seg.dtype == np.int64 and int(seg.max()) > 2**31


def test_reconstruct_without_parts_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tchunks.reconstruct(str(tmp_path))


def _cell_fields(c):
    return (c.image_coords, c.center, c.unique_id, c.is_bad, c.volume, c.signal_stats,
            c.gfp_stats)


def _same(a, b):
    """Equal, with NaN equal to NaN (statistics of bad cells)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
def test_generate_cell_objects_equals_jax(dtype):
    rng = np.random.default_rng(2)
    labels = np.zeros((40, 36, 5), np.int32)
    labels[2:9, 3:10, 1:4] = 1
    labels[12:20, 12:18, 0:5] = 4
    labels[30, 30, 2] = 7  # a one-voxel (bad) cell
    labels[25:35, 2:9, 2:3] = 9
    img = rng.random((40, 36, 5, 4))
    img = (img * 65535).astype(np.uint16) if dtype == "uint16" else ((img - 0.5) / 0.5).astype(np.float32)
    got = thaircell.generate_cell_objects(img, labels, x_ind_chunk=100, y_ind_chunk=7)
    want = jhaircell.generate_cell_objects(img, labels, x_ind_chunk=100, y_ind_chunk=7)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _same(_cell_fields(g), _cell_fields(w))
    assert any(c.is_bad for c in got)

    curve = np.stack([np.linspace(0, 140, 60), np.linspace(0, 60, 60)])
    pct = np.linspace(0, 1, 60)
    for g, w in zip(got, want):
        g.set_frequency(curve, pct)
        w.set_frequency(curve, pct)
        assert g.distance_from_apex == w.distance_from_apex


def test_cochlear_length_equals_jax():
    """The synthetic spiral of
    ``test_instance_and_analysis.py::test_cochlear_length_on_synthetic_spiral``."""
    t = np.linspace(0, 3.5 * np.pi, 4000)
    r = 120 + 38 * t
    cx = 500 + r * np.cos(t)
    cy = 500 + r * np.sin(t)
    img = np.zeros((1000, 1000), np.float64)
    for dx in range(-55, 56, 3):
        for dy in range(-55, 56, 3):
            img[np.clip(cx + dx, 0, 999).astype(int), np.clip(cy + dy, 0, 999).astype(int)] = 1.0
    got = tcochlea.get_cochlear_length(img, equal_spaced_distance=2)
    want = jcochlea.get_cochlear_length(img, equal_spaced_distance=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] > 10
    with pytest.raises(ValueError, match="vanished"):
        tcochlea.get_cochlear_length(np.zeros((50, 50)))


@pytest.mark.parametrize("percent", ["distinct", "none"])
def test_cells_to_csv_bytes_equal_jax(tmp_path, percent):
    rng = np.random.default_rng(3)
    labels = np.zeros((60, 60, 4), np.int32)
    for i, (x, y) in enumerate([(5, 5), (30, 8), (8, 40), (40, 40), (50, 20)]):
        labels[x : x + 6, y : y + 5, 1:3] = i + 1
    labels[20, 20, 0] = 9  # bad: NaN statistics
    img = rng.random((60, 60, 4, 4)).astype(np.float32)
    cells = thaircell.generate_cell_objects(img, labels, x_ind_chunk=3, y_ind_chunk=1000)
    if percent == "distinct":
        for c, p in zip(cells, rng.permutation(len(cells))):
            c.distance_from_apex = float(p) / 7 + 1e-3
    texport.cells_to_csv(cells, str(tmp_path / "port.csv"))
    jexport.cells_to_csv(cells, str(tmp_path / "jax.csv"))
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert got.count(b"\n") == len(cells) + 1
    texport.cells_to_csv([], str(tmp_path / "empty.csv"))
    jexport.cells_to_csv([], str(tmp_path / "jempty.csv"))
    assert (tmp_path / "empty.csv").read_bytes() == (tmp_path / "jempty.csv").read_bytes()


def test_render_size_and_lines_equal_jax(tmp_path):
    labels = np.zeros((30, 30, 3), np.int32)
    labels[5:10, 5:10, :] = 1
    labels[12:29, 2:29, :] = 3
    got = texport.render_size(labels, out_path=str(tmp_path / "size.npy"), small=100, large=1000)
    want = jexport.render_size(labels, out_path=None, small=100, large=1000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "size.npy"), np.transpose(want, (2, 1, 0)))
    np.testing.assert_array_equal(texport.mask_to_lines(labels), jexport.mask_to_lines(labels))
    np.testing.assert_array_equal(texport.color_from_ind(5), jexport.color_from_ind(5))


def test_transforms_and_tiff_equal_jax(tmp_path):
    from hcunet_tpu.data import tiff as jtiff
    from hcunet_tpu.data import transforms as jtransforms

    for dt in (np.uint8, np.uint16, np.int16):
        assert ttransforms.integer_unit_scale(dt) == jtransforms.integer_unit_scale(dt)
    with pytest.raises(TypeError):
        ttransforms.integer_unit_scale(np.float32)
    vol = (np.random.default_rng(4).random((3, 10, 12, 4)) * 65535).astype(np.uint16)
    np.testing.assert_array_equal(ttransforms.to_float()(vol), jtransforms.to_float()(vol))
    np.testing.assert_array_equal(ttransforms.reshape()(vol), jtransforms.reshape()(vol))
    for name in ("v.npy", "v.tif"):
        path = str(tmp_path / name)
        ttiff.imwrite(path, vol)
        np.testing.assert_array_equal(ttiff.imread(path), jtiff.imread(path))
        np.testing.assert_array_equal(ttiff.imread(path), vol)
    np.savez(tmp_path / "v.npz", vol)
    np.testing.assert_array_equal(ttiff.imread(str(tmp_path / "v.npz")), vol)


def test_tiff_without_pil_names_pil(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        ttiff.imread(str(tmp_path / "missing.tif"))
    ttiff.imwrite(str(tmp_path / "ok.npy"), np.zeros(3))  # numpy paths need no PIL
    assert os.path.exists(tmp_path / "ok.npy")
