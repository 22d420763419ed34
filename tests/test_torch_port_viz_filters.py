"""The modules the port took over last from the JAX package, against their
twins on the same seeded numpy inputs, on the CPU: the window filters of
``ops/filters.py`` (``maximum_filter``, ``binary_dilation``,
``binary_erosion``, ``binary_dilation_n``) for odd and even windows and
subsets of the axes, ``ops/distance.py::chamfer_edt_host``,
``core/padding.py::reflection_pad_np`` and ``analysis/viz.py`` under
matplotlib's Agg backend.

Tolerance: none anywhere.  The filters take maxima and minima, which do
not round, so they are held equal element for element (and in dtype); the
numpy copies run the same numpy code; the viz arrays are equal, and the
plotted boxes' line data equal.
"""

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from hcunet_tpu.analysis import viz as jviz  # noqa: E402
from hcunet_tpu.core.padding import reflection_pad_np as jax_reflection_pad_np  # noqa: E402
from hcunet_tpu.ops import filters as jfilters  # noqa: E402
from hcunet_tpu.ops.distance import chamfer_edt_host as jax_chamfer  # noqa: E402
from hcunet_tpu_torch.analysis import viz  # noqa: E402
from hcunet_tpu_torch.core import reflection_pad_np  # noqa: E402
from hcunet_tpu_torch.ops import filters  # noqa: E402
from hcunet_tpu_torch.ops.distance import chamfer_edt_host  # noqa: E402

SHAPE = (11, 9, 6)
AXES = [None, (0, 1), (2,), (-1, 0)]


def _volume(seed=0):
    """Normal values: negatives meet the maximum filter's zero pad."""
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def _binary(seed=0, density=0.6):
    return np.random.default_rng(seed).random(SHAPE) < density


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axes", AXES, ids=str)
@pytest.mark.parametrize("size", [2, 3, 4, 5])
def test_maximum_filter_matches_jax(size, axes):
    """Even sizes pad ``size // 2`` low (scipy's origin); the zero pad
    clips negative values at the border; the dtype stays float32."""
    x = _volume(size)
    want = jfilters.maximum_filter(jnp.asarray(x), size, axes=axes)
    _same(filters.maximum_filter(torch.from_numpy(x), size, axes=axes), want)


def test_maximum_filter_even_window_is_scipys():
    """The even window's origin is scipy's, not ``_window_reduce``'s: on
    a non-negative input (where the zero pad changes nothing) the filter
    equals ``scipy.ndimage.maximum_filter(mode='constant')``."""
    from scipy import ndimage as ndi

    x = np.abs(_volume(7))
    for size in (2, 4):
        got = filters.maximum_filter(torch.from_numpy(x), size).numpy()
        np.testing.assert_array_equal(got, ndi.maximum_filter(x, size, mode="constant"))


@pytest.mark.parametrize("axes", AXES, ids=str)
@pytest.mark.parametrize("op", ["binary_dilation", "binary_erosion"])
def test_binary_morphology_matches_jax(op, axes):
    """bool out, 3-wide windows; erosion's zero pad erodes the border."""
    x = _binary(len(op))
    want = getattr(jfilters, op)(jnp.asarray(x), axes=axes)
    _same(getattr(filters, op)(torch.from_numpy(x), axes=axes), want)


@pytest.mark.parametrize("axes", [None, (0, 1)], ids=str)
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_binary_dilation_n_matches_jax(iterations, axes):
    x = _binary(iterations, density=0.05)
    want = jfilters.binary_dilation_n(jnp.asarray(x), iterations, axes=axes)
    _same(filters.binary_dilation_n(torch.from_numpy(x), iterations, axes=axes), want)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, bool], ids=["f32", "u8", "bool"])
def test_binary_ops_take_any_dtype(dtype):
    """The binary ops cast to float32 first, as their twins do."""
    x = _binary(3).astype(dtype)
    for op in ("binary_dilation", "binary_erosion"):
        want = getattr(jfilters, op)(jnp.asarray(x), axes=(0, 1))
        _same(getattr(filters, op)(torch.from_numpy(x), axes=(0, 1)), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_chamfer_edt_host_matches_jax(seed):
    """Exact: the same two-pass program, with a foreground that touches
    the border and an all-foreground row."""
    b = np.random.default_rng(seed).random((13, 17)) < 0.8
    b[4] = True
    got = chamfer_edt_host(b)
    want = jax_chamfer(b)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pad", [(2, 4, 1), (0, 3, 2), (6, 2, 3)], ids=str)
def test_reflection_pad_np_matches_jax(pad):
    """``[B, X, Y, Z, C]``; the last case pads X by more than its size (numpy
    reflects again)."""
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(reflection_pad_np(x, pad), jax_reflection_pad_np(x, pad))


class _Cell:
    def __init__(self, coords, is_bad=False):
        self.image_coords = coords
        self.is_bad = is_bad


def test_construct_instance_mask_matches_jax():
    """Overlapping boxes (the earlier cell keeps the overlap) and a bad
    cell; ``base_mask`` as a tensor too."""
    cells = [_Cell((1, 1, 0, 6, 5, 3)), _Cell((4, 3, 1, 9, 8, 4)),
             _Cell((0, 0, 0, 3, 3, 2), is_bad=True), _Cell((7, 0, 2, 10, 4, 5))]
    base = np.zeros((10, 9, 5), np.uint8)
    want = jviz.construct_instance_mask(cells, base)
    for b in (base, torch.from_numpy(base)):
        got = viz.construct_instance_mask(cells, b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_labels_to_rgb_matches_jax():
    labels = np.random.default_rng(2).integers(0, 7, (12, 10))
    want = jviz.labels_to_rgb(labels)
    np.testing.assert_array_equal(viz.labels_to_rgb(labels), want)
    np.testing.assert_array_equal(viz.labels_to_rgb(torch.from_numpy(labels)), want)


def _plotted(fn, *args, **kwargs):
    plt.figure()
    try:
        ax = fn(*args, **kwargs)
        lines = [(ln.get_xdata().tolist(), ln.get_ydata().tolist(), ln.get_color())
                 for ln in ax.get_lines()]
        images = [np.asarray(im.get_array()) for im in ax.get_images()]
    finally:
        plt.close("all")
    return lines, images


def test_show_box_pred_plots_what_jax_plots():
    """Boxes under the threshold are skipped; each kept box draws four
    lines in its class's color; a negative image is denormalized."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((24, 20)).astype(np.float32)
    cand = {"boxes": np.asarray([[2, 3, 10, 12], [5, 1, 20, 9], [0, 0, 4, 4]], np.float32),
            "scores": np.asarray([0.95, 0.5, 0.99], np.float32),
            "labels": np.asarray([1, 2, 3], np.int32)}
    want = _plotted(jviz.show_box_pred, img, cand, threshold=0.9)
    got = _plotted(viz.show_box_pred, torch.from_numpy(img),
                   {k: torch.from_numpy(v) for k, v in cand.items()}, threshold=0.9)
    assert len(got[0]) == len(want[0]) == 8
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1][0], want[1][0])


def test_imshow_denormalized_matches_jax():
    img = np.random.default_rng(4).standard_normal((8, 6, 3)).astype(np.float32)
    want = _plotted(jviz.imshow_denormalized, img)
    got = _plotted(viz.imshow_denormalized, torch.from_numpy(img))
    np.testing.assert_array_equal(got[1][0], want[1][0])
