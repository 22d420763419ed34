"""Minimal multi-page TIFF IO built on PIL (twin of
``hcunet_tpu/data/tiff.py``).

The reference leans on ``skimage.io.imread`` (tifffile underneath) which is
not in this environment; PIL reads/writes multipage TIFFs fine for the
confocal exports this pipeline consumes.  Layout convention on disk follows
the reference/skimage: 3D stacks are ``[Z, Y, X, C]`` (or ``[Z, Y, X]``),
2D images ``[Y, X, C]``.

Real confocal exports (the reference's input, ``hcat/dataloader.py:40-63``)
are **ImageJ hyperstacks**: uint16, one single-channel page per (z, c) with
channel varying fastest, and an ``ImageJ=...`` ImageDescription on the
first page declaring ``images/channels/slices``.  ``imread`` detects that
metadata and de-interleaves pages back to ``[Z, Y, X, C]``; ``imwrite``
produces the same layout for multi-channel volumes PIL can't store as
color pages (e.g. uint16 or C not in {3, 4}).

``.npy``/``.npz`` paths pass straight through to numpy — convenient for
synthetic fixtures and faster for large volumes — and need no PIL.  PIL is
imported only for a TIFF, and its absence raises an ``ImportError`` that
says so.
"""

from __future__ import annotations

import numpy as np

_DESCRIPTION_TAG = 270  # TIFF ImageDescription


def _pil():
    """``PIL.Image`` and ``PIL.ImageSequence``, or an ImportError naming PIL."""
    try:
        from PIL import Image, ImageSequence
    except ImportError as e:
        raise ImportError(
            "reading or writing a TIFF needs PIL (Pillow); pass .npy/.npz "
            "paths or a volume array where it is not installed"
        ) from e
    return Image, ImageSequence


def _parse_imagej_description(desc) -> dict:
    """Parse an ImageJ ImageDescription blob into a key→value dict."""
    if isinstance(desc, bytes):
        desc = desc.decode("latin-1", "ignore")
    if not isinstance(desc, str) or not desc.startswith("ImageJ"):
        return {}
    meta = {}
    for line in desc.replace("\r", "\n").split("\n"):
        if "=" in line:
            k, _, v = line.partition("=")
            meta[k.strip()] = v.strip()
    return meta


def imread(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[list(z.files)[0]]
    Image, ImageSequence = _pil()
    with Image.open(path) as im:
        desc = im.tag_v2.get(_DESCRIPTION_TAG, "") if hasattr(im, "tag_v2") else ""
        frames = [np.asarray(f.copy()) for f in ImageSequence.Iterator(im)]

    meta = _parse_imagej_description(desc)
    if meta and len(frames) > 1 and frames[0].ndim == 2:
        channels = int(meta.get("channels", 1))
        slices = int(meta.get("slices", len(frames) // max(channels, 1)))
        if channels > 1 and channels * slices == len(frames):
            stack = np.stack(frames, axis=0)  # [Z*C, Y, X], channel fastest
            stack = stack.reshape(slices, channels, *stack.shape[1:])
            arr = np.moveaxis(stack, 1, -1)  # [Z, Y, X, C]
            return arr[0] if slices == 1 else arr

    if len(frames) == 1:
        return frames[0]
    return np.stack(frames, axis=0)


def imwrite(path: str, array: np.ndarray) -> None:
    if path.endswith(".npy"):
        np.save(path, array)
        return
    Image, _ = _pil()
    arr = np.asarray(array)
    # PIL can store uint8 C∈{3,4} natively as color pages; everything else
    # multi-channel goes out as an ImageJ hyperstack of grayscale pages.
    color_ok = arr.dtype == np.uint8 and arr.ndim >= 3 and arr.shape[-1] in (3, 4)
    if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and (arr.shape[-1] == 1 or color_ok)):
        Image.fromarray(_to_pil_compatible(arr)).save(path)
        return
    if arr.ndim == 4 and not color_ok:
        _write_hyperstack(path, arr)
        return
    if arr.ndim == 3 and arr.shape[-1] in (2, 3, 4) and not color_ok:
        _write_hyperstack(path, arr[None])
        return
    # multipage: leading axis = pages
    pages = [Image.fromarray(_to_pil_compatible(a)) for a in arr]
    pages[0].save(path, save_all=True, append_images=pages[1:])


def _write_hyperstack(path: str, arr: np.ndarray) -> None:
    """Write [Z, Y, X, C] as an ImageJ hyperstack (C fastest, grayscale
    pages, ImageJ description on page 0) — round-trips through
    :func:`imread` and through ImageJ/tifffile readers."""
    Image, _ = _pil()
    z, _, _, c = arr.shape
    planes = np.moveaxis(arr, -1, 1).reshape(z * c, *arr.shape[1:3])
    desc = (
        f"ImageJ=1.53t\nimages={z * c}\nchannels={c}\nslices={z}\n"
        "hyperstack=true\nmode=grayscale\n"
    )
    pages = [Image.fromarray(_to_pil_compatible(p)) for p in planes]
    pages[0].save(
        path,
        save_all=True,
        append_images=pages[1:],
        tiffinfo={_DESCRIPTION_TAG: desc},
    )


def _to_pil_compatible(a: np.ndarray) -> np.ndarray:
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.dtype == np.int64 or a.dtype == np.int32:
        return a.astype(np.int32)
    if a.dtype in (np.float64,):
        return a.astype(np.float32)
    return a
