"""Training-target generators (twin of ``hcunet_tpu/train/targets.py``, a
numpy/scipy module the port keeps its own copy of): vectorized rebuilds of
``hcat/train/train_utils.py``.

The reference's numba triple-loops become numpy/scipy array ops:

* :func:`make_pwl` — the U-Net paper pixel-weight map
  ``w0 · exp(-(d1+d2)² / 2σ²)`` (w0=11, σ=5) where d1/d2 are the distances
  to the two nearest *distinct* cells.  The reference ray-marches 63 angles
  × radii 1–10 per background pixel (``train_utils.py:62-93``); here it is
  K per-label distance transforms with a two-smallest reduction — exact
  distances rather than the reference's coarse ray quantization.
* :func:`make_mask` — instance-color masks from RGB "amira" exports:
  background removal + stripping the boundary between differently-colored
  touching cells (``train_utils.py:96-187``), via neighbor shifts.
* :func:`center_of_mass_target` / :func:`vector_to_center` — per-cell
  center maps and normalized pixel→center offset fields
  (``train_utils.py:190-274``).

Layouts follow the on-disk convention ``[Z, Y, X, C]`` like the reference's
preprocessing (these run once per training volume, host-side).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage as ndi


def colors_to_labels(color_image: np.ndarray) -> np.ndarray:
    """Map an RGB(A) instance-color volume [Z, Y, X, C] to int labels,
    background (the corner color) = 0."""
    if color_image.ndim == 3:
        color_image = np.stack([color_image] * 3, axis=3)
    flat = color_image.reshape(-1, color_image.shape[-1])
    colors, inverse = np.unique(flat, axis=0, return_inverse=True)
    labels = inverse.reshape(color_image.shape[:-1]).astype(np.int32) + 1
    background_color = color_image[0, 0, 0, :]
    bg_idx = np.nonzero((colors == background_color).all(axis=1))[0]
    if len(bg_idx):
        labels[labels == bg_idx[0] + 1] = 0
    return labels


def make_pwl(
    color_mask: np.ndarray,
    w0: float = 11.0,
    sigma: float = 5.0,
    per_slice: bool = True,
    max_labels: int = 512,
    ray_march: bool = False,
) -> np.ndarray:
    """Pixel-wise loss weights for a color-coded instance mask [Z,Y,X,C].

    Returns float64 [Z, Y, X]; nonzero only on background pixels near at
    least two distinct cells.

    ``ray_march=True`` selects the reference-exact 63-ray quantized
    distance (:func:`make_pwl_ray_march`).  The default exact-EDT map is a
    refinement of it: the ray march overestimates d1+d2 by integer-radius
    quantization and truncates at radius 9; measured delta on the standard
    two-cell fixture is mean |Δ| < 0.25 over background with peak positions
    within one pixel (tests/test_train_and_targets.py).
    """
    if ray_march:
        return make_pwl_ray_march(color_mask, w0=w0, sigma=sigma)
    labels = colors_to_labels(color_mask)
    ids = np.unique(labels)
    ids = ids[ids != 0]
    if len(ids) > max_labels:
        raise ValueError(f"{len(ids)} labels exceeds max_labels={max_labels}")
    out = np.zeros(labels.shape, np.float64)
    if len(ids) < 2:
        return out

    Z = labels.shape[0]
    for z in range(Z) if per_slice else [None]:
        sl = labels[z] if per_slice else labels
        zids = np.unique(sl)
        zids = zids[zids != 0]
        if len(zids) < 2:
            continue
        dists = np.stack(
            [ndi.distance_transform_edt(sl != i) for i in zids], axis=0
        )
        dists.sort(axis=0)
        d12 = dists[0] + dists[1]
        w = w0 * np.exp(-(d12**2) / (2 * sigma**2))
        w[sl != 0] = 0.0
        if per_slice:
            out[z] = w
        else:
            out[...] = w
    return out


_RAY_RADII = np.arange(1, 10)
_RAY_ANGLES = np.linspace(0, 2 * np.pi, 63)


def _ray_offsets() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's scan-ordered (radius, dy, dx) ray table
    (``train_utils.py:62-76``): radii 1..9 outer, 63 angles inner,
    offsets rounded to integers (duplicates kept, order preserved)."""
    radii, dys, dxs = [], [], []
    for l in _RAY_RADII:
        for theta in _RAY_ANGLES:
            dxs.append(int(np.rint(l * np.cos(theta))))
            dys.append(int(np.rint(l * np.sin(theta))))
            radii.append(l)
    return np.array(radii), np.array(dys), np.array(dxs)


def make_pwl_ray_march(
    color_mask: np.ndarray, w0: float = 11.0, sigma: float = 5.0
) -> np.ndarray:
    """Reference-exact PWL: the 63-angle × radii-1..9 ray march of
    ``train_utils.py:50-93``, vectorized.

    Per background pixel, rays are scanned in order (radius-major); the
    first nonzero hit fixes the nearest cell's color at radius ``l1``, the
    first *later* hit whose color differs fixes ``l2``, and the weight is
    ``w0·exp(-(l1+l2)²/2σ²)`` — 0 if no two distinct cells are seen within
    radius 9.  Matches the reference's 50-pixel pad (rays near the volume
    edge see background, never wrap).  Returns float64 [Z, Y, X].
    """
    labels = colors_to_labels(color_mask)
    radii, dys, dxs = _ray_offsets()
    pad = int(_RAY_RADII.max())
    out = np.zeros(labels.shape, np.float64)
    n = len(radii)
    for z in range(labels.shape[0]):
        sl = np.pad(labels[z], pad)  # zero pad == reference's 50-pad
        # hits[k, y, x] = label seen by ray k from pixel (y, x)
        hits = np.empty((n,) + labels.shape[1:], labels.dtype)
        H, W = labels.shape[1:]
        for k in range(n):
            y0, x0 = pad + dys[k], pad + dxs[k]
            hits[k] = sl[y0 : y0 + H, x0 : x0 + W]
        nonzero = hits != 0
        any_hit = nonzero.any(axis=0)
        i1 = np.argmax(nonzero, axis=0)
        c1 = np.take_along_axis(hits, i1[None], axis=0)[0]
        scan = np.arange(n)[:, None, None]
        distinct = nonzero & (hits != c1[None]) & (scan > i1[None])
        any_distinct = distinct.any(axis=0)
        i2 = np.argmax(distinct, axis=0)
        l1 = radii[i1].astype(np.float64)
        l2 = radii[i2].astype(np.float64)
        w = w0 * np.exp(-((l1 + l2) ** 2) / (2 * sigma**2))
        valid = any_hit & any_distinct & (labels[z] == 0)
        out[z][valid] = w[valid]
    return out


def make_mask(color_image: np.ndarray, erosion: bool = False) -> np.ndarray:
    """Clean an RGB instance export: zero the background color, then strip
    pixels whose 4-neighborhood (in-plane) contains a *different*
    non-background color — the inter-cell boundary
    (``train_utils.py:147-172``).  Returns the cleaned color volume.
    """
    if color_image.ndim == 3:
        color_image = np.stack([color_image] * 3, axis=3)
    image = color_image.copy()
    background = image[0, 0, 0, :].copy()
    is_bg = (image == background).all(axis=-1)
    image[is_bg] = 0
    background = np.zeros_like(background)

    lab = colors_to_labels(image)
    strip = np.zeros(lab.shape, bool)
    for axis, shift in ((1, 1), (1, -1), (2, 1), (2, -1)):
        neigh = np.roll(lab, shift, axis=axis)
        # roll wraps; invalidate the wrapped edge
        sl = [slice(None)] * lab.ndim
        sl[axis] = slice(0, 1) if shift == 1 else slice(-1, None)
        valid = np.ones(lab.shape, bool)
        valid[tuple(sl)] = False
        strip |= valid & (lab != 0) & (neigh != 0) & (neigh != lab)
    image[strip] = 0

    if erosion:
        binary = (image != 0).any(axis=-1)
        eroded = np.stack(
            [ndi.binary_erosion(binary[z]) for z in range(binary.shape[0])]
        )
        image[~eroded] = 0
    return image


def center_of_mass_target(
    color_image: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell integer-id volume plus a sparse center map with the id
    painted at each cell's rounded center of mass
    (``train_utils.py:190-237``)."""
    labels = colors_to_labels(color_image)
    centers = np.zeros(labels.shape, np.float64)
    ids = np.unique(labels)
    ids = ids[ids != 0]
    if len(ids):
        coms = ndi.center_of_mass(labels != 0, labels, ids)
        for i, com in zip(ids, coms):
            z, y, x = (int(np.round(c)) for c in com)
            z = np.clip(z, 0, labels.shape[0] - 1)
            y = np.clip(y, 0, labels.shape[1] - 1)
            x = np.clip(x, 0, labels.shape[2] - 1)
            centers[z, y, x] = i
    return centers, labels.astype(np.uint32)


def vector_to_center(centers: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-pixel offset to the pixel's own cell center, normalized by the
    volume shape (``train_utils.py:240-274``).  Returns [Z, Y, X, 3]
    ordered (z, y, x) like the reference."""
    vec = np.zeros(labels.shape + (3,), np.float64)
    ids = np.unique(labels)
    ids = ids[ids != 0]
    zz, yy, xx = np.indices(labels.shape)
    for i in ids:
        com = np.argwhere(centers == i)
        if len(com) == 0:
            continue
        cz, cy, cx = com[0]
        m = labels == i
        vec[m, 0] = zz[m] - cz
        vec[m, 1] = yy[m] - cy
        vec[m, 2] = xx[m] - cx
    vec[..., 0] /= labels.shape[0]
    vec[..., 1] /= labels.shape[1]
    vec[..., 2] /= labels.shape[2]
    return vec


def preprocess_volume(color_mask_path: str, out_dir: str = None):
    """One training volume end-to-end: mask cleanup + COM + vector targets —
    the per-file body of the reference's Ray fan-out
    (``preprocess_manual_masks.py:37-73``).  Writes ``.labels.com.tif`` and
    ``.labels.vector.pkl`` next to the input."""
    import os
    import pickle

    from hcunet_tpu_torch.data.tiff import imread, imwrite

    color = imread(color_mask_path)
    cleaned = make_mask(color)
    centers, labels = center_of_mass_target(cleaned)
    vec = vector_to_center(centers, labels)
    stem = color_mask_path
    for suffix in (".labels.tif", ".tif", ".npy"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    out_dir = out_dir or os.path.dirname(color_mask_path)
    base = os.path.join(out_dir, os.path.basename(stem))
    imwrite(base + ".labels.com.tif", centers.astype(np.uint16))
    with open(base + ".labels.vector.pkl", "wb") as f:
        pickle.dump(vec, f)
    return centers, labels, vec
