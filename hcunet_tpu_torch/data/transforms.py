"""Data transforms (twin of ``hcunet_tpu/data/transforms.py``): the
explicit-RNG redesign of ``hcat/transforms.py``.

The reference drives joint augmentation through numpy's *global* seed via the
``joint_transform`` decorator (``transforms.py:15-91``): one random seed per
call, re-seeded before each image so the same transform hits image/mask/pwl.
Here every random transform takes a ``numpy.random.Generator``; joint
application just passes the same freshly-spawned generator to each image —
no global state, safely parallelizable across workers.  The port keeps the
JAX package's numpy code as it is, so the same generator seed gives the same
arrays in both packages.

All transforms operate host-side on numpy arrays in the framework's
``[X, Y, Z, C]`` (or 2D ``[X, Y, C]``) channels-last layout; ``to_batch``
produces the ``[1, X, Y, Z, C]`` device layout.  :func:`device_normalize` is
the on-device normalize, on torch tensors.

Behavioral notes vs the reference:
* ``drop_channel``/``random_intensity`` in the reference fire when
  ``np.random.random() > chance`` — i.e. ``chance`` is the probability of
  *not* applying (``transforms.py:294,318``).  The canonical recipe calls
  ``drop_channel(.8)``, firing 20% of the time.  We keep named semantics
  honest: ``rate`` here is the probability of applying; construct with
  ``rate=1-chance`` to mirror a reference config.
* ``random_crop``'s 2D branch in the reference passes reversed arguments to
  ``randint`` (``transforms.py:388-389``) and crashes for crops smaller than
  the image; ours is the straightforward correct crop.
* ``elastic_deform`` reproduces the elasticdeform library's algorithm
  (B-spline displacement grid evaluated over the volume) with
  ``scipy.ndimage.map_coordinates``; order-0 is used for single-channel
  (mask-like) images, as in ``transforms.py:436-444``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage as ndi
import torch


Arrays = List[np.ndarray]


# ---------------------------------------------------------------------------
# layout / dtype
# ---------------------------------------------------------------------------


def integer_unit_scale(dtype) -> float:
    """The [0,1] rescale divisor for an integer image dtype.

    Matches :class:`to_float` and the reference (``transforms.py:94-115``):
    ``2**bits`` (256 / 65536), NOT ``iinfo.max`` (255 / 65535) — every
    integer-ingestion path in the pipeline must use this same constant or
    probabilities near thresholds silently shift by ~0.39% (uint8)."""
    dt = np.dtype(dtype)
    if not np.issubdtype(dt, np.integer):
        raise TypeError(f"expected an integer dtype, got {dt}")
    return float(2 ** (8 * dt.itemsize))


class to_float:
    """uint8/uint16 → float in [0,1] (``transforms.py:94-115``)."""

    def __call__(self, images, rng=None):
        single = not isinstance(images, list)
        if single:
            images = [images]
        out = []
        for im in images:
            if im.dtype == np.uint16:
                im = im.astype(np.float64) / 2**16
            elif im.dtype == np.uint8:
                im = im.astype(np.float64) / 2**8
            elif np.issubdtype(im.dtype, np.floating):
                pass
            else:
                raise TypeError(f"expected uint8/uint16/float, got {im.dtype}")
            out.append(im)
        return out[0] if single else out


class reshape:
    """skimage layout [Z,Y,X,C] → [X,Y,Z,C] (2D: [Y,X,C] → [X,Y,C]);
    swapaxes(ndim-2, 0) exactly as ``transforms.py:139-156``."""

    def __call__(self, images, rng=None):
        single = not isinstance(images, list)
        if single:
            images = [images]
        out = [im.swapaxes(im.ndim - 2, 0) for im in images]
        return out[0] if single else out


class to_batch:
    """[*spatial, C] → float32 [1, *spatial, C] (device layout)."""

    def __call__(self, images, rng=None):
        single = not isinstance(images, list)
        if single:
            images = [images]
        out = [np.ascontiguousarray(im, dtype=np.float32)[None] for im in images]
        return out[0] if single else out


class clean_image:
    """nan→0, inf→1 (``transforms.py:616-631``)."""

    def __call__(self, images, rng=None):
        single = not isinstance(images, list)
        if single:
            images = [images]
        out = []
        for im in images:
            im = im.copy()
            im[np.isnan(im)] = 0
            im[np.isinf(im)] = 1
            out.append(im)
        return out[0] if single else out


# ---------------------------------------------------------------------------
# intensity (image-only)
# ---------------------------------------------------------------------------


class spekle:
    """Additive gaussian noise, clamped to [0,1] (``transforms.py:159-183``)."""

    def __init__(self, gamma: float = 0.1):
        if gamma > 1:
            raise ValueError(f"spekle gamma should be <= 1, got {gamma}")
        self.gamma = gamma

    def __call__(self, image: np.ndarray, rng: np.random.Generator):
        noise = rng.normal(0, self.gamma, image.shape).astype(np.float32)
        out = image + noise
        return np.clip(out, 0, 1)


class random_gamma:
    """Gamma jitter: x**g for g ~ U(range) (``transforms.py:186-197``)."""

    def __init__(self, gamma_range: Tuple[float, float] = (0.8, 1.2)):
        self.gamma_range = gamma_range

    def __call__(self, image: np.ndarray, rng: np.random.Generator):
        factor = max(float(rng.uniform(*self.gamma_range)), 0.0)
        return np.power(image, factor)


class normalize:
    """Per-channel (x - mean) / std (``transforms.py:257-282``)."""

    def __init__(self, mean: Optional[Sequence[float]] = None, std=None):
        self.mean = np.asarray(mean if mean is not None else [0.5] * 4)
        self.std = np.asarray(std if std is not None else [0.5] * 4)

    def __call__(self, image: np.ndarray, rng=None):
        if isinstance(image, list):
            image = image[0]
        c = image.shape[-1]
        return (image - self.mean[:c]) / self.std[:c]


class drop_channel:
    """Zero one random channel with probability ``rate``
    (``transforms.py:285-298``; see module docstring re inverted chance)."""

    def __init__(self, rate: float):
        self.rate = rate

    def __call__(self, image: np.ndarray, rng: np.random.Generator):
        if rng.random() < self.rate:
            image = image.copy()
            image[..., rng.integers(0, image.shape[-1])] = 0
        return image


class random_intensity:
    """Per-channel intensity offset + cleanup (``transforms.py:301-334``)."""

    def __init__(self, range: Tuple[int, int] = (-30, 30), rate: float = 1.0):
        self.range = range
        self.rate = rate

    def __call__(self, image: np.ndarray, rng: np.random.Generator):
        image = image.copy()
        vals = rng.integers(self.range[0], self.range[1], image.shape[-1]) / 100
        for c in range(image.shape[-1]):
            if rng.random() < self.rate:
                image[..., c] -= vals[c]
        image[image < 0] = 0
        image[np.isnan(image)] = 0
        image[np.isinf(image)] = 1
        return image


# ---------------------------------------------------------------------------
# geometry (joint)
# ---------------------------------------------------------------------------


def _joint(images, fn, rng):
    """Apply ``fn(image, rng_clone)`` identically to every image."""
    single = not isinstance(images, list)
    if single:
        images = [images]
    if len({im.ndim for im in images}) > 1:
        raise ValueError("images in joint transforms must share ndim")
    seed = rng.integers(0, 2**31 - 1)
    out = [fn(im, np.random.default_rng(seed)) for im in images]
    return out[0] if single else out


class random_affine:
    """Random xy-plane affine shear (the reference's version raises
    ``NotImplemented`` at ``transforms.py:200-203``; this one works).
    Order-0 resampling keeps masks label-crisp."""

    def __init__(self, max_shear: float = 0.2):
        self.max_shear = max_shear

    def __call__(self, images, rng: np.random.Generator):
        def fn(im, r):
            sx, sy = r.uniform(-self.max_shear, self.max_shear, 2)
            mat = np.eye(im.ndim)
            mat[0, 1] = sx
            mat[1, 0] = sy
            return ndi.affine_transform(
                im.astype(np.float64), mat, order=0, output_shape=im.shape,
                mode="reflect",
            )

        return _joint(images, fn, rng)


class random_rotate:
    """Random (or fixed) xy-plane rotation, order 0
    (``transforms.py:230-254``)."""

    def __init__(self, angle: Optional[float] = None):
        self.angle = angle

    def __call__(self, images, rng: np.random.Generator):
        def fn(im, r):
            theta = self.angle if self.angle else int(r.integers(0, 360))
            return ndi.rotate(
                im.astype(np.float64), axes=(0, 1), angle=theta, reshape=False,
                order=0, mode="constant", prefilter=False,
            )

        return _joint(images, fn, rng)


class random_crop:
    """Joint random crop to ``dim`` with small-Z fallback
    (``transforms.py:337-396``)."""

    def __init__(self, dim: Sequence[int]):
        self.dim = np.asarray(dim)

    def __call__(self, images, rng: np.random.Generator):
        def fn(im, r):
            dim = self.dim.copy()
            spatial = np.asarray(im.shape[:-1])
            dim = np.minimum(dim[: len(spatial)], spatial)
            starts = [int(r.integers(0, s - d + 1)) for s, d in zip(spatial, dim)]
            slc = tuple(slice(st, st + d) for st, d in zip(starts, dim)) + (
                slice(None),
            )
            return im[slc]

        return _joint(images, fn, rng)


class nul_crop:
    """Crop away x rows / y cols where the mask is empty — needs the mask to
    crop all images, so it takes the list directly (``transforms.py:460-489``;
    image list convention [image, mask, ...])."""

    def __init__(self, rate: float = 1.0):
        self.rate = rate

    def __call__(self, image_list: Arrays, rng: np.random.Generator):
        if not isinstance(image_list, list):
            raise ValueError("nul_crop needs the [image, mask, ...] list")
        if rng.random() >= self.rate:
            return image_list
        mask = image_list[1]
        lr = mask.sum(axis=1).sum(axis=1).flatten() > 1
        if not lr.any():
            raise ValueError(
                "nul_crop removed every row: the mask sums below the "
                "reference's >1 threshold. On-disk masks are expected "
                "0/255-valued (to_float scales them to 0/1); a 0/1-valued "
                "mask file lands at 1/255 and crops to nothing."
            )
        image_list = [im[lr] for im in image_list]
        mask = image_list[1]
        ud = mask.sum(axis=0).sum(axis=1).flatten() > 1
        return [im[:, ud] for im in image_list]


class elastic_deform:
    """Random B-spline grid deformation (elasticdeform-style,
    ``transforms.py:399-457``): a coarse ``grid_shape`` displacement field
    scaled by ``scale`` is B-spline-interpolated over the volume and applied
    with ``map_coordinates``; masks (C==1) use order 0, clamped to [0,1]."""

    def __init__(self, grid_shape: Tuple[int, ...] = (5, 5, 5), scale: float = 5.0):
        self.grid_shape = grid_shape
        self.scale = scale

    def _dense_displacement(self, disp_grid, spatial):
        """Upsample the coarse grid to the full volume, per axis."""
        nd = len(spatial)
        dense = []
        for axis_field in disp_grid:  # [*grid_shape]
            # place grid points over the volume like elasticdeform: grid
            # coordinates map linearly onto the image extent
            zoom = [s / g for s, g in zip(spatial, axis_field.shape)]
            dense.append(
                ndi.zoom(axis_field, zoom, order=3, mode="nearest", prefilter=True)
            )
        return dense

    def __call__(self, images, rng: np.random.Generator):
        def fn(im, r):
            spatial = im.shape[:-1]
            nd = len(spatial)
            grid = self.grid_shape[:nd]
            disp = r.standard_normal((nd, *grid)) * self.scale
            dense = self._dense_displacement(disp, spatial)
            coords = np.meshgrid(
                *[np.arange(s, dtype=np.float64) for s in spatial], indexing="ij"
            )
            coords = [c + d for c, d in zip(coords, dense)]
            order = 0 if im.shape[-1] == 1 else 3
            out = np.empty_like(im, dtype=np.float64)
            for c in range(im.shape[-1]):
                out[..., c] = ndi.map_coordinates(
                    im[..., c].astype(np.float64), coords, order=order, mode="reflect"
                )
            return np.clip(out, 0, 1)

        return _joint(images, fn, rng)


# ---------------------------------------------------------------------------
# detection (image + boxes)
# ---------------------------------------------------------------------------


class random_x_flip:
    """Flip along X, remap box corners (``transforms.py:494-530``)."""

    def __init__(self, rate: float = 0.5):
        self.rate = rate

    def __call__(self, image, boxes, labels=None, rng: np.random.Generator = None):
        boxes = np.asarray(boxes, dtype=np.int64).reshape(-1, 4)
        if rng.random() < self.rate and len(boxes):
            image = np.ascontiguousarray(image[::-1])
            h = image.shape[0]
            boxes = boxes.copy()
            boxes[:, [1, 3]] = -boxes[:, [3, 1]] + h
        return image, boxes.tolist(), labels


class random_y_flip:
    """Flip along Y, remap box corners (``transforms.py:533-557``)."""

    def __init__(self, rate: float = 0.5):
        self.rate = rate

    def __call__(self, image, boxes, labels=None, rng: np.random.Generator = None):
        boxes = np.asarray(boxes, dtype=np.int64).reshape(-1, 4)
        if rng.random() < self.rate and len(boxes):
            image = np.ascontiguousarray(image[:, ::-1])
            w = image.shape[1]
            boxes = boxes.copy()
            boxes[:, [0, 2]] = -boxes[:, [2, 0]] + w
        return image, boxes.tolist(), labels


class random_resize:
    """Scale image and boxes together (``transforms.py:560-587``)."""

    def __init__(self, rate: float = 0.5, scale: Tuple[float, float] = (0.8, 1.2)):
        self.rate = rate
        self.scale = scale

    def __call__(self, image, boxes, labels=None, rng: np.random.Generator = None):
        if rng.random() >= self.rate:
            return image, boxes, labels
        s = float(rng.uniform(*self.scale))
        zoom = [s] * (image.ndim - 1) + [1]
        image = ndi.zoom(image, zoom, order=1)
        boxes = np.round(np.asarray(boxes, dtype=np.float64) * s).astype(np.int64)
        return image, boxes.tolist(), labels


class remove_channel:
    """Keep only the given channel indexes (``transforms.py:590-613``)."""

    def __init__(self, remaining_channel_index=(0, 2, 3)):
        self.index_remain = tuple(remaining_channel_index)

    def __call__(self, image, rng=None):
        if image.shape[-1] == len(self.index_remain):
            return image
        return image[..., list(self.index_remain)]


class add_junk_image:
    """Paste a random crop of a junk tif into the image and drop overlapped
    boxes (``transforms.py:634-725``)."""

    def __init__(self, junk_images: Sequence[np.ndarray],
                 junk_image_size=(100, 100)):
        if not junk_images:
            raise FileNotFoundError("no junk images provided")
        self.images = list(junk_images)
        self.junk_image_size = junk_image_size

    def __call__(self, image, boxes, labels=None, rng: np.random.Generator = None):
        junk = self.images[int(rng.integers(0, len(self.images)))]
        jh, jw = self.junk_image_size
        if junk.shape[0] <= jh or junk.shape[1] <= jw:
            raise ValueError("junk image smaller than requested crop")
        jx = int(rng.integers(0, junk.shape[0] - jh - 1))
        jy = int(rng.integers(0, junk.shape[1] - jw - 1))
        patch = junk[jx : jx + jh, jy : jy + jw]

        image = image.copy()
        x = int(rng.integers(0, image.shape[0] - jh - 1))
        y = int(rng.integers(0, image.shape[1] - jw - 1))
        image[x : x + jh, y : y + jw, : patch.shape[-1]] = patch[
            ..., : image.shape[-1]
        ]

        kept, kept_labels = [], []
        for i, box in enumerate(boxes):
            bx = np.asarray(box)[[0, 2]]
            by = np.asarray(box)[[1, 3]]
            hit_x = np.any((bx > x) & (bx < x + jh))
            hit_y = np.any((by > y) & (by < y + jw))
            if not (hit_x or hit_y):
                kept.append(box)
                if labels is not None:
                    kept_labels.append(labels[i])
        return image, kept, (None if labels is None else kept_labels)


def distance_transform(image: np.ndarray) -> np.ndarray:
    """Per-z-slice exact EDT of a dilated binary mask — the alternative
    training target of ``transforms.py:728-752`` (which used cv2's chamfer;
    exact here).  ``image``: [Z, ...] uint8."""
    if image.dtype != np.uint8:
        raise ValueError(f"image dtype is not uint8: {image.dtype}")
    dilated = ndi.binary_dilation(image > 0)
    out = np.zeros(image.shape, np.float64)
    for z in range(image.shape[0]):
        out[z] = ndi.distance_transform_edt(dilated[z])
    return out


# ---------------------------------------------------------------------------
# device-side variants
# ---------------------------------------------------------------------------


def device_normalize(image: torch.Tensor, mean, std) -> torch.Tensor:
    """Per-channel normalize of a tensor on its own device."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=image.device)
    return (image - mean) / std
