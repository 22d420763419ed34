"""Cochlear path fitting → tonotopic position (twin of
``hcunet_tpu/analysis/cochlea.py``, numpy/scipy).

Rebuild of ``hcat/utils.py:127-253`` (``get_cochlear_length``): max-project
the mask, downscale 10×, clean up, skeletonize the spiral, convert to polar
coordinates about the center of mass, unwrap the 2π break, fit a B-spline,
smooth r(θ) with a Gaussian-process RBF regression, then emit equally-spaced
points along the curve with a base→apex percentage.

Third-party pieces the reference used and their replacements here:
* ``skimage.morphology.skeletonize`` → Zhang–Suen thinning (numpy);
* ``skimage.morphology.diameter_closing`` → small-hole filling via
  connected components of the background;
* ``GPy`` RBF ``GPRegression`` → closed-form GP with RBF kernel and a small
  marginal-likelihood hyperparameter search (numpy/scipy).
* ``scipy.interpolate.splprep/splev`` are available and used directly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage as ndi
from scipy.interpolate import splev, splprep


# ---------------------------------------------------------------------------
# morphology helpers
# ---------------------------------------------------------------------------


def downscale_local_mean(image: np.ndarray, factors: Tuple[int, int]) -> np.ndarray:
    fx, fy = factors
    X = (image.shape[0] // fx) * fx
    Y = (image.shape[1] // fy) * fy
    # skimage pads with zeros to a multiple; do the same
    px = (-image.shape[0]) % fx
    py = (-image.shape[1]) % fy
    img = np.pad(image.astype(np.float64), ((0, px), (0, py)))
    return img.reshape(
        img.shape[0] // fx, fx, img.shape[1] // fy, fy
    ).mean(axis=(1, 3))


def fill_small_holes(binary: np.ndarray, max_diameter: int = 10) -> np.ndarray:
    """Fill background components whose bbox diagonal < max_diameter
    (stand-in for ``diameter_closing`` on a binary image)."""
    inv = ~binary
    lab, n = ndi.label(inv)
    out = binary.copy()
    for comp_id, slc in enumerate(ndi.find_objects(lab), start=1):
        if slc is None:
            continue
        h = slc[0].stop - slc[0].start
        w = slc[1].stop - slc[1].start
        if max(h, w) < max_diameter:
            # only fill enclosed holes (not border-touching background),
            # and only this component's own pixels — the bbox may also
            # contain pixels of other background components
            if (
                slc[0].start > 0
                and slc[1].start > 0
                and slc[0].stop < binary.shape[0]
                and slc[1].stop < binary.shape[1]
            ):
                out[slc][lab[slc] == comp_id] = True
    return out


_ZS_NEIGHBORS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def skeletonize(binary: np.ndarray) -> np.ndarray:
    """Zhang–Suen thinning to a 1-pixel-wide skeleton."""
    img = np.pad(binary.astype(np.uint8), 1)

    def neighbors(y, x):
        return [img[y + dy, x + dx] for dy, dx in _ZS_NEIGHBORS]

    changed = True
    while changed:
        changed = False
        for phase in (0, 1):
            to_del = []
            ys, xs = np.nonzero(img[1:-1, 1:-1])
            for y, x in zip(ys + 1, xs + 1):
                p = neighbors(y, x)
                b = sum(p)
                if not (2 <= b <= 6):
                    continue
                a = sum(
                    1
                    for k in range(8)
                    if p[k] == 0 and p[(k + 1) % 8] == 1
                )
                if a != 1:
                    continue
                p2, p4, p6, p8 = p[0], p[2], p[4], p[6]
                if phase == 0:
                    if p2 * p4 * p6 != 0 or p4 * p6 * p8 != 0:
                        continue
                else:
                    if p2 * p4 * p8 != 0 or p2 * p6 * p8 != 0:
                        continue
                to_del.append((y, x))
            if to_del:
                changed = True
                for y, x in to_del:
                    img[y, x] = 0
    return img[1:-1, 1:-1].astype(bool)


# ---------------------------------------------------------------------------
# GP regression (RBF)
# ---------------------------------------------------------------------------


class GPRegressorRBF:
    """Exact GP regression with an RBF kernel, hyperparameters fit by a
    coarse marginal-likelihood grid search (drop-in for the reference's
    GPy usage at ``utils.py:217-222``)."""

    def __init__(self, variance=100.0, lengthscale=5.0, noise=1.0):
        self.variance = variance
        self.lengthscale = lengthscale
        self.noise = noise

    @staticmethod
    def _k(xa, xb, variance, lengthscale):
        d2 = (xa[:, None] - xb[None, :]) ** 2
        return variance * np.exp(-0.5 * d2 / lengthscale**2)

    def fit(self, x: np.ndarray, y: np.ndarray, max_points: int = 1500):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        if len(x) > max_points:
            idx = np.linspace(0, len(x) - 1, max_points).astype(int)
            x, y = x[idx], y[idx]
        self._x, self._ymean = x, y.mean()
        yc = y - self._ymean

        best = (np.inf, self.variance, self.lengthscale, self.noise)
        n = len(x)
        for ls in (self.lengthscale * f for f in (0.25, 0.5, 1.0, 2.0, 4.0)):
            for noise in (0.1, 1.0, 10.0):
                K = self._k(x, x, self.variance, ls) + noise * np.eye(n)
                try:
                    L = np.linalg.cholesky(K)
                except np.linalg.LinAlgError:
                    continue
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, yc))
                nll = 0.5 * yc @ alpha + np.log(np.diag(L)).sum()
                if nll < best[0]:
                    best = (nll, self.variance, ls, noise)
        _, self.variance, self.lengthscale, self.noise = best
        K = self._k(x, x, self.variance, self.lengthscale) + self.noise * np.eye(n)
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(self._L.T, np.linalg.solve(self._L, yc))
        return self

    def predict(self, xq: np.ndarray) -> np.ndarray:
        xq = np.asarray(xq, np.float64).ravel()
        ks = self._k(xq, self._x, self.variance, self.lengthscale)
        return ks @ self._alpha + self._ymean


# ---------------------------------------------------------------------------
# the cochlear-length pipeline
# ---------------------------------------------------------------------------


def get_cochlear_length(
    image: np.ndarray,
    equal_spaced_distance: float = 0.1,
    diagnostics: bool = False,
):
    """``image``: 2D max-projection of the semantic mask ([X, Y], nonzero =
    cell).  Returns ``(curve [2, N], percentage [N], apex [2])``.
    """
    image = downscale_local_mean(image, (10, 10)) > 0
    image = ndi.binary_closing(image)
    image = fill_small_holes(image, 10)
    for _ in range(5):
        image = ndi.binary_erosion(image)
    image = skeletonize(image)
    image = image.astype(np.float64)
    image[np.isnan(image)] = 0

    if image.sum() < 4:
        raise ValueError("cochlear skeleton vanished — mask too sparse")

    center_of_mass = np.array(ndi.center_of_mass(image))
    while (
        0 <= int(center_of_mass[0]) < image.shape[0]
        and 0 <= int(center_of_mass[1]) < image.shape[1]
        and image[int(center_of_mass[0]), int(center_of_mass[1])] > 0
    ):
        center_of_mass += 1

    x, y = image.nonzero()
    x = x - int(center_of_mass[0])
    y = y - int(center_of_mass[1])

    r = np.sqrt(x**2 + y**2).astype(np.float64)
    theta = np.arctan2(x, y)

    ind = theta.argsort()
    theta, r = theta[ind], r[ind]

    # unwrap the 2π break where the spiral is cut (utils.py:183-190)
    if len(theta) > 2:
        loc = np.abs(theta[0:-2:1] - theta[1:-1:1])
        theta[loc.argmax() :] += -2 * np.pi
        ind = theta.argsort()[1:-1:1]
        theta, r = theta[ind], r[ind]

    tck, u = splprep(
        [theta, r], w=np.ones(len(r)) / len(r), s=1.5e-6, k=3
    )

    gp = GPRegressorRBF(variance=100.0, lengthscale=5.0).fit(theta, r)
    r_ = gp.predict(theta)
    theta_ = theta

    x_spline = r_ * np.cos(theta_) + center_of_mass[1]
    y_spline = r_ * np.sin(theta_) + center_of_mass[0]

    equal_spaced_points = []
    base = None
    for i, coord in enumerate(zip(x_spline, y_spline)):
        if i == 0:
            base = coord
            equal_spaced_points.append(base)
        if (
            np.sqrt((base[0] - coord[0]) ** 2 + (base[1] - coord[1]) ** 2)
            > equal_spaced_distance
        ):
            equal_spaced_points.append(coord)
            base = coord

    equal_spaced_points = np.array(equal_spaced_points).T * 10  # undo downscale

    curve = tck[1][0]
    if curve[0] > curve[-1]:
        apex = equal_spaced_points[:, -1]
        percentage = np.linspace(1, 0, equal_spaced_points.shape[1])
    else:
        apex = equal_spaced_points[:, 0]
        percentage = np.linspace(0, 1, equal_spaced_points.shape[1])

    if not diagnostics:
        return equal_spaced_points, percentage, apex
    return equal_spaced_points, x_spline, y_spline, image, tck, u
