"""Result exports: CSV and QA renders (twin of
``hcunet_tpu/analysis/export.py``).

Rebuilds ``hcat/utils.py:515-540`` (``cells_to_csv``) and
``hcat/validate/render_size.py`` (size-outlier QA tif).
"""

from __future__ import annotations

import csv
import math
from typing import List, Optional

import numpy as np

CSV_COLUMNS = ("center", "unique_id", "percent_location", "mean_gfp", "volume")


def _csv_field(v) -> str:
    """A value as pandas' ``to_csv`` writes it: empty for None and NaN, the
    shortest round-trip text of a float, ``str`` of anything else."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    return str(v)


def cells_to_csv(all_cells: List, file_name: str) -> None:
    """One row per cell, sorted by ``percent_location`` with the cells that
    have none last, in their own order (stable), and the cell's position in
    ``all_cells`` as the unnamed index column: the bytes the JAX package's
    pandas writer produces (``DataFrame.sort_values(...).to_csv``), written
    with the ``csv`` module."""
    rows = [
        (i, [c.center, c.unique_id, c.distance_from_apex, c.gfp_stats.get("mean"), c.volume])
        for i, c in enumerate(all_cells)
    ]

    def missing(v) -> bool:
        return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))

    known = [r for r in rows if not missing(r[1][2])]
    known.sort(key=lambda r: r[1][2])  # list.sort is stable
    ordered = known + [r for r in rows if missing(r[1][2])]
    with open(file_name, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", *CSV_COLUMNS])
        for i, vals in ordered:
            w.writerow([str(i), *(_csv_field(v) for v in vals)])


def render_size(
    unique_mask: np.ndarray,
    out_path: Optional[str] = "size_validation.tif",
    small: int = 5000,
    large: int = 15000,
) -> np.ndarray:
    """Paint cells into 3 classes by voxel count: too-small (<small) = 1,
    too-big (>large) = 3, normal = 2 (``render_size.py:6-24``).

    ``unique_mask``: [X, Y, Z] int labels.  Returns the class volume and
    writes a multipage tif when ``out_path`` is given.
    """
    ids, counts = np.unique(unique_mask, return_counts=True)
    lut = np.zeros(int(ids.max()) + 1 if len(ids) else 1, np.uint8)
    for i, c in zip(ids, counts):
        if i == 0:
            continue
        lut[int(i)] = 1 if c < small else (3 if c > large else 2)
    classes = lut[unique_mask]
    if out_path:
        from hcunet_tpu_torch.data.tiff import imwrite

        # save as [Z, Y, X] pages like the reference's tif exports
        imwrite(out_path, np.transpose(classes, (2, 1, 0)))
    return classes


def mask_to_lines(labels: np.ndarray) -> np.ndarray:
    """Interior-pixel detector for outline-only overlays
    (``hcat/utils.py:463-501``): True where a pixel equals all four in-plane
    neighbors — vectorized instead of the reference's numba prange loops."""
    interior = np.zeros(labels.shape, bool)
    core = labels[1:-1, 1:-1, :]
    same = (
        (core == labels[:-2, 1:-1, :])
        & (core == labels[2:, 1:-1, :])
        & (core == labels[1:-1, :-2, :])
        & (core == labels[1:-1, 2:, :])
        & (core != 0)
    )
    interior[1:-1, 1:-1, :] = same
    return interior


def color_from_ind(i: int) -> np.ndarray:
    """Deterministic pseudo-random RGBA for a label id
    (``hcat/utils.py:504-512``)."""
    rng = np.random.default_rng(i)
    return rng.random(4) / 0.5
