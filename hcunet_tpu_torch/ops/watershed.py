"""Seeded watershed on the host (twin of ``hcunet_tpu/ops/watershed.py``).

Replaces ``skimage.segmentation.watershed`` as called by the instance
segmenter (``hcat/segment.py:468-471``): seeded, mask-limited, connectivity
1 (faces), compactness, watershed_line.  The priority flood is inherently
sequential, so the exact version runs on the host: ``csrc/watershed_host.cpp``
(the port's own copy of ``native/watershed.cpp``), built by ``g++`` with
``native/Makefile``'s flags at first use and bound with ``ctypes``, which
releases the GIL so that tile workers flood concurrently.  Its labels are
bit-identical to the JAX package's host flood.  The bounded-iteration
approximation on the card is :mod:`hcunet_tpu_torch.ops.watershed_device`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from hcunet_tpu_torch.csrc import HostLibrary

_F64 = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.POINTER(ctypes.c_int64)
_I, _D = ctypes.c_int, ctypes.c_double

WATERSHED_HOST = HostLibrary(
    "watershed_host.cpp",
    {
        "watershed3d": [_F64, _I32, _U8, _I64, _I, _D, _I],
        "label3d": [_U8, _I32, _I64],
        "instance_tile3d": [_F64, _U8, _I32, _I32, _I64, _I, _I, _D, _D, _I, _D, _I],
    },
)


def _as3d(a: np.ndarray) -> np.ndarray:
    return a[..., None] if a.ndim == 2 else a


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def watershed(
    image: np.ndarray,
    markers: np.ndarray,
    mask: Optional[np.ndarray] = None,
    connectivity: int = 1,
    compactness: float = 0.0,
    watershed_line: bool = False,
) -> np.ndarray:
    """Flood ``image`` ascending from ``markers`` (int labels), returning the
    int32 label volume.  2D or 3D, [X, Y(, Z)]."""
    lib = WATERSHED_HOST.load()
    squeeze = image.ndim == 2
    img = np.ascontiguousarray(_as3d(np.asarray(image)), np.float64)
    out = np.ascontiguousarray(_as3d(np.asarray(markers)), np.int32).copy()
    if mask is None:
        msk = np.ones(img.shape, np.uint8)
    else:
        msk = np.ascontiguousarray(_as3d(np.asarray(mask)) != 0).astype(np.uint8)
    if out.min() < 0:
        raise ValueError("marker labels must be positive integers")
    if img.shape != out.shape or img.shape != msk.shape:
        raise ValueError(
            f"shape mismatch: image {img.shape}, markers {out.shape}, mask {msk.shape}"
        )
    dims = np.asarray(img.shape, np.int64)
    rc = lib.watershed3d(
        _ptr(img, _F64), _ptr(out, _I32), _ptr(msk, _U8), _ptr(dims, _I64),
        int(connectivity), float(compactness), int(bool(watershed_line)),
    )
    if rc != 0:
        raise RuntimeError(f"watershed3d failed with code {rc}")
    return out[..., 0] if squeeze else out


def instance_tile(
    distance: np.ndarray,
    binary: np.ndarray,
    seed: np.ndarray,
    *,
    expand_z: int,
    expand_mask: int,
    distance_floor: float,
    seed_background_below: float,
    connectivity: int = 1,
    compactness: float = 0.0,
    watershed_line: bool = True,
) -> np.ndarray:
    """Fused per-tile instance step (``hcat/segment.py:444-480``): the exact
    equivalent of z-replicating ``distance``/``seed``/``binary`` by
    ``expand_z``, flooring the height, dilating the mask ``expand_mask``
    times (cross structuring element), background-seeding below
    ``seed_background_below``, running the compact seeded watershed with
    lines on ``-distance`` and decimating z back, without materializing the
    expanded float64 volumes.

    All inputs are UNEXPANDED ``[X, Y, Z]``.  Returns int32 labels (line
    pixels 0); background label 1 is kept (the caller zeroes it, matching
    ``segment.py:475``).
    """
    lib = WATERSHED_HOST.load()
    img = np.ascontiguousarray(np.asarray(distance), np.float64)
    msk = np.ascontiguousarray(np.asarray(binary) != 0).astype(np.uint8)
    sd = np.ascontiguousarray(np.asarray(seed), np.int32)
    if img.shape != msk.shape or img.shape != sd.shape or img.ndim != 3:
        raise ValueError(
            f"shape mismatch: distance {img.shape}, binary {msk.shape}, "
            f"seed {sd.shape}"
        )
    out = np.zeros(img.shape, np.int32)
    dims = np.asarray(img.shape, np.int64)
    rc = lib.instance_tile3d(
        _ptr(img, _F64), _ptr(msk, _U8), _ptr(sd, _I32), _ptr(out, _I32),
        _ptr(dims, _I64), int(expand_z), int(expand_mask), float(distance_floor),
        float(seed_background_below), int(connectivity), float(compactness),
        int(bool(watershed_line)),
    )
    if rc != 0:
        raise RuntimeError(f"instance_tile3d failed with code {rc}")
    return out


def label(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """Connected components (face connectivity). Returns (labels, count)."""
    lib = WATERSHED_HOST.load()
    squeeze = binary.ndim == 2
    b = np.ascontiguousarray(_as3d(np.asarray(binary)) != 0).astype(np.uint8)
    out = np.zeros(b.shape, np.int32)
    dims = np.asarray(b.shape, np.int64)
    n = lib.label3d(_ptr(b, _U8), _ptr(out, _I32), _ptr(dims, _I64))
    return (out[..., 0] if squeeze else out), int(n)
