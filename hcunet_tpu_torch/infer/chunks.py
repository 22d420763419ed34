"""Chunk spill/merge — the crash-resumable chunk store (twin of
``hcunet_tpu/infer/chunks.py``, numpy only).

Rebuild of ``hcat/mask.py`` (``Part``) and
``hcat/utils.py:256-333`` (``reconstruct_mask``/``reconstruct_segmented``):
per-chunk records of (probability mask, instance mask, top-left location)
with null-compression for empty chunks, written to disk so a crashed
whole-cochlea run resumes mid-image, then reassembled with instance ids
renumbered across chunks.

Implementation notes: ``.npz`` instead of pickle (no arbitrary code on
load, compressed); renumbering is max-id offsetting exactly like
``utils.py:320-327``.  The spill format (``.maskpart.npz`` and its members)
is the JAX package's, so either package reconstructs the other's spills.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class Part:
    """One chunk's results.  ``mask``: [X, Y, Z] float/uint8 semantic mask;
    ``segmented_mask``: [X, Y, Z] int labels; ``loc``: global (x, y) of the
    chunk's top-left corner."""

    mask: Optional[np.ndarray]
    segmented_mask: Optional[np.ndarray]
    loc: Tuple[int, int]
    shape: Tuple[int, ...]
    mask_dtype: np.dtype
    # fixed-point spill: when set, ``mask`` holds the raw uint16 map that
    # crossed the d2h link (``PipelineConfig.prob_transfer_dtype="uint16"``)
    # and ``dense_mask`` dequantizes by this float32 multiplier — the spill
    # then carries the same 2 B/voxel the link did instead of re-inflating
    # to float32 (the production spill set halves, 6 → 3 GB).  Bit-exact
    # with spilling the dequantized float32: uint16→float32 is exact and
    # the multiply is the same f32 scalar op the collect path applies.
    mask_scale: Optional[float] = None

    @classmethod
    def create(
        cls,
        mask: np.ndarray,
        segmented_mask: np.ndarray,
        loc,
        mask_scale: Optional[float] = None,
    ) -> "Part":
        if segmented_mask is not None and segmented_mask.size:
            smax = int(segmented_mask.max())
            if smax == 0:
                segmented_mask = None
            elif smax < 2**16 and int(segmented_mask.min()) >= 0:
                # chunk-local label counts are small; uint16 halves the
                # spill (reconstruct offsets into an int32/int64 canvas,
                # so cross-chunk totals are unaffected)
                segmented_mask = segmented_mask.astype(np.uint16)
        else:
            segmented_mask = None
        return cls(
            mask=None if mask.sum() == 0 else mask,
            segmented_mask=segmented_mask,
            loc=tuple(int(v) for v in loc),
            shape=tuple(mask.shape),
            # the LOGICAL dtype: quantized spills reconstruct to float32
            mask_dtype=np.dtype(np.float32) if mask_scale is not None else mask.dtype,
            mask_scale=mask_scale,
        )

    def dense_mask(self) -> np.ndarray:
        if self.mask is None:
            return np.zeros(self.shape, self.mask_dtype)
        if self.mask_scale is not None:
            out = self.mask.astype(np.float32)
            out *= np.float32(self.mask_scale)
            return out
        return self.mask

    def dense_segmented(self) -> np.ndarray:
        return (
            self.segmented_mask
            if self.segmented_mask is not None
            else np.zeros(self.shape, np.int32)
        )

    def save(self, path: str, compress: bool = False) -> None:
        """Spill to ``path``.  ``compress`` trades disk for CPU: zlib costs
        seconds per production chunk on the deflate side and again at every
        reconstruct — on a host-CPU-bound pipeline the uncompressed default
        keeps the chunk tail and the final reconstruct off the critical path
        (the reference's pickle spill was uncompressed too, ``mask.py:17``)."""
        writer = np.savez_compressed if compress else np.savez
        members = dict(
            loc=np.asarray(self.loc),
            shape=np.asarray(self.shape),
            mask=self.mask if self.mask is not None else np.zeros(0, self.mask_dtype),
            segmented=self.segmented_mask
            if self.segmented_mask is not None
            else np.zeros(0, np.int32),
            dtype=str(np.dtype(self.mask_dtype)),
        )
        if self.mask_scale is not None:
            members["mask_scale"] = np.float64(self.mask_scale)
        writer(path, **members)

    @classmethod
    def load(cls, path: str) -> "Part":
        with np.load(path, allow_pickle=False) as z:
            shape = tuple(int(v) for v in z["shape"])
            dtype = np.dtype(str(z["dtype"]))
            mask = z["mask"] if z["mask"].size else None
            seg = z["segmented"] if z["segmented"].size else None
            scale = float(z["mask_scale"]) if "mask_scale" in z.files else None
            return cls(
                mask=mask,
                segmented_mask=seg,
                loc=tuple(int(v) for v in z["loc"]),
                shape=shape,
                mask_dtype=dtype,
                mask_scale=scale,
            )


PART_EXT = ".maskpart.npz"


def _parts(path: str):
    files = sorted(glob.glob(os.path.join(path, f"*{PART_EXT}")))
    if not files:
        raise FileNotFoundError(f"no valid part files found under {path}")
    return [Part.load(f) for f in files]


def _canvas_shape(parts) -> Tuple[int, int, int]:
    x_max = max(p.loc[0] + p.shape[0] for p in parts)
    y_max = max(p.loc[1] + p.shape[1] for p in parts)
    z = parts[0].shape[-1]
    return x_max, y_max, z


def _paste_mask(out, p: Part) -> None:
    x, y = p.loc
    out[x : x + p.shape[0], y : y + p.shape[1], :] = p.dense_mask()


def _paste_segmented(out, p: Part, max_id: int) -> int:
    """Paste one part's labels offset by ``max_id``; returns the running
    max.  Chunks never overlap, so the canvas maximum after the paste is
    ``max(max_id, max_id + part.max())`` — tracked part-locally instead of
    re-scanning the whole (multi-GB at production scale) canvas per part."""
    x, y = p.loc
    seg = p.dense_segmented().astype(out.dtype)
    part_max = int(seg.max()) if seg.size else 0
    if part_max:
        seg[seg != 0] += max_id
    out[x : x + p.shape[0], y : y + p.shape[1], :] = seg
    return max_id + part_max


def _segmented_dtype(parts):
    """int32 holds any realistic cross-chunk id total; guard anyway (the
    per-part maxima bound the renumbered total from above)."""
    total = sum(
        int(p.segmented_mask.max()) for p in parts if p.segmented_mask is not None
    )
    return np.int64 if total >= 2**31 else np.int32


def reconstruct_mask(path: str) -> np.ndarray:
    """Reassemble the semantic mask from spilled parts ([X, Y, Z])."""
    parts = _parts(path)
    X, Y, Z = _canvas_shape(parts)
    out = np.zeros((X, Y, Z), parts[0].mask_dtype)
    for p in parts:
        _paste_mask(out, p)
    return out


def reconstruct_segmented(path: str) -> np.ndarray:
    """Reassemble the instance mask, renumbering ids across chunks
    (``utils.py:294-333``)."""
    parts = _parts(path)
    X, Y, Z = _canvas_shape(parts)
    out = np.zeros((X, Y, Z), _segmented_dtype(parts))
    max_id = 0
    for p in parts:
        max_id = _paste_segmented(out, p, max_id)
    return out


def _npz_member_into(zf, name: str, scratch: dict) -> Optional[np.ndarray]:
    """Read one ``.npy`` member of an open ZipFile into a reused scratch
    buffer, returning a view (valid until the next call).

    ``np.load`` allocates a fresh array per member; at production scale a
    reconstruct walk allocates ~6 GB that way, and on lazily-backed VMs
    (this rig faults anonymous pages at ~0.1 GB/s) the repeated first-touch
    cost dominates the whole reassembly.  One grow-only buffer pays the
    fault cost once.  Returns None for empty (null-compressed) members."""
    import struct

    with zf.open(name) as fp:
        magic = fp.read(8)
        if magic[:6] != b"\x93NUMPY":
            raise ValueError(f"{name}: not an npy member")
        if magic[6] == 1:
            (hlen,) = struct.unpack("<H", fp.read(2))
        else:
            (hlen,) = struct.unpack("<I", fp.read(4))
        import ast

        hdr = ast.literal_eval(fp.read(hlen).decode("latin1"))
        dtype = np.dtype(hdr["descr"])
        shape = hdr["shape"]
        if hdr.get("fortran_order"):
            raise ValueError(f"{name}: fortran-order spill unsupported")
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if n == 0:
            return None
        buf = scratch.get("buf")
        if buf is None or len(buf) < n:
            buf = scratch["buf"] = bytearray(n)
        mv = memoryview(buf)[:n]
        got = 0
        while got < n:
            r = fp.readinto(mv[got:])
            if not r:
                raise IOError(f"{name}: truncated npy member")
            got += r
        return np.frombuffer(mv, dtype).reshape(shape)


def reconstruct(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Reassemble BOTH canvases in one streaming pass over the part files.

    ``reconstruct_mask`` + ``reconstruct_segmented`` each load (and, for
    compressed spills, inflate) every part — ~6 GB of part data read twice
    at production scale, through per-member fresh allocations.  Here every
    part is read once, straight into reused scratch buffers, and pasted
    into both canvases (measured at the 6144²×20/25-chunk production
    geometry: 148 s → ~60 s, fault- and canvas-bound)."""
    import zipfile

    files = sorted(glob.glob(os.path.join(path, f"*{PART_EXT}")))
    if not files:
        raise FileNotFoundError(f"no valid part files found under {path}")
    # metadata pass: locs/shapes/dtypes + per-part segmented maxima come
    # from the tiny members, so canvases can be allocated up front
    metas = []
    for f in files:
        with zipfile.ZipFile(f) as zf:
            small = {}
            sc: dict = {}
            names = set(zf.namelist())
            for name in ("loc.npy", "shape.npy", "dtype.npy"):
                arr = _npz_member_into(zf, name, sc)
                small[name] = None if arr is None else arr.copy()
            scale = None
            if "mask_scale.npy" in names:
                scale = float(_npz_member_into(zf, "mask_scale.npy", sc))
            metas.append(
                (
                    tuple(int(v) for v in small["loc.npy"]),
                    tuple(int(v) for v in small["shape.npy"]),
                    np.dtype(str(small["dtype.npy"])),
                    scale,
                )
            )
    X = max(loc[0] + shp[0] for loc, shp, *_ in metas)
    Y = max(loc[1] + shp[1] for loc, shp, *_ in metas)
    Z = metas[0][1][-1]
    mask = np.zeros((X, Y, Z), metas[0][2])
    seg = np.zeros((X, Y, Z), np.int32)
    max_id = 0
    scratch: dict = {}
    nz = None
    for f, (loc, shp, _dt, scale) in zip(files, metas):
        x, y = loc
        sx, sy = shp[0], shp[1]
        with zipfile.ZipFile(f) as zf:
            m = _npz_member_into(zf, "mask.npy", scratch)
            if m is not None:
                mregion = mask[x : x + sx, y : y + sy, :]
                mregion[...] = m  # uint16 fixed-point upcasts exactly
                if scale is not None:
                    # same f32 scalar multiply the collect path applies —
                    # bit-identical to spilling the dequantized float32
                    np.multiply(
                        mregion, np.float32(scale), out=mregion
                    )
            s = _npz_member_into(zf, "segmented.npy", scratch)
            if s is not None:
                part_max = int(s.max())
                if part_max and max_id + part_max >= np.iinfo(seg.dtype).max:
                    # cross-chunk ids would wrap int32 — upgrade the canvas
                    # once and keep going (reconstruct_segmented's int64
                    # path, inlined; astronomically rare, costs one copy)
                    seg = seg.astype(np.int64)
                    nz = None
                region = seg[x : x + sx, y : y + sy, :]
                region[...] = s
                if max_id and part_max:
                    if nz is None or nz.shape != region.shape:
                        nz = np.empty(region.shape, bool)
                    np.not_equal(region, 0, out=nz)
                    np.add(region, max_id, out=region, where=nz)
                max_id += part_max
    return mask, seg
