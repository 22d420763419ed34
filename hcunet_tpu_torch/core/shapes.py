"""Valid-convolution shape algebra.

The entire HcUnet pipeline is built around *valid* (padding=0) convolutions:
the network output is strictly smaller than its input, losses crop targets to
the prediction, and the tiled-inference engine adds compensating reflection
padding.  The reference scatters this arithmetic across
``hcat/unet.py:318-340`` (crop), ``hcat/loss.py:50-56`` (crop-to-valid),
``hcat/utils.py:77-124`` (tile indexes) and ``hcat/segment.py:103-126``
(valid-region extraction).  Here it lives in one pure, unit-tested module so
every layer of the port shares a single source of truth.

All functions are plain Python over ints/tuples.  This is the port's own copy
of ``hcunet_tpu/core/shapes.py``, so that importing the port never loads JAX.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

IntOrTuple = "int | Tuple[int, ...]"


def _as_tuple(v, n: int) -> Tuple[int, ...]:
    """Broadcast an int to an n-tuple, or validate an existing tuple."""
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    if len(t) != n:
        raise ValueError(f"expected length-{n} tuple, got {t}")
    return t


def conv_output_shape(
    spatial: Sequence[int],
    kernel,
    stride=1,
    dilation=1,
) -> Tuple[int, ...]:
    """Spatial output shape of a valid (padding=0) convolution.

    out = floor((in - dilation*(kernel-1) - 1) / stride) + 1
    """
    n = len(spatial)
    kernel = _as_tuple(kernel, n)
    stride = _as_tuple(stride, n)
    dilation = _as_tuple(dilation, n)
    out = []
    for s, k, st, d in zip(spatial, kernel, stride, dilation):
        eff = d * (k - 1) + 1
        if s < eff:
            raise ValueError(
                f"valid conv: input {s} smaller than effective kernel {eff}"
            )
        out.append((s - eff) // st + 1)
    return tuple(out)


def pool_output_shape(spatial: Sequence[int], kernel, stride=None) -> Tuple[int, ...]:
    """Spatial output shape of a max pool (stride defaults to kernel)."""
    n = len(spatial)
    kernel = _as_tuple(kernel, n)
    stride = kernel if stride is None else _as_tuple(stride, n)
    return tuple((s - k) // st + 1 for s, k, st in zip(spatial, kernel, stride))


def conv_transpose_output_shape(
    spatial: Sequence[int], kernel, stride=1
) -> Tuple[int, ...]:
    """Spatial output shape of a transposed conv with no padding.

    out = (in - 1) * stride + kernel   (torch ConvTranspose semantics,
    output_padding=0, padding=0).
    """
    n = len(spatial)
    kernel = _as_tuple(kernel, n)
    stride = _as_tuple(stride, n)
    return tuple((s - 1) * st + k for s, k, st in zip(spatial, kernel, stride))


def unet_output_shape(
    spatial: Sequence[int],
    *,
    n_levels: int,
    kernel1,
    kernel2,
    pool,
    up_kernel,
    up_stride,
) -> Tuple[int, ...]:
    """Output spatial shape of the valid-conv U-Net.

    ``n_levels`` is the number of feature sizes; there are ``n_levels - 1``
    pools and up-steps.  Mirrors ``Unet_Constructor.forward``
    (reference ``hcat/unet.py:125-143``): down blocks are two valid convs,
    up blocks are transpose-conv then two valid convs with the skip cropped
    to the upsampled size.
    """
    sizes = list(spatial)
    skips: List[Tuple[int, ...]] = []
    for _ in range(n_levels - 1):
        sizes = list(conv_output_shape(sizes, kernel1))
        sizes = list(conv_output_shape(sizes, kernel2))
        skips.append(tuple(sizes))
        sizes = list(pool_output_shape(sizes, pool))
    # bottom block
    sizes = list(conv_output_shape(sizes, kernel1))
    sizes = list(conv_output_shape(sizes, kernel2))
    for _ in range(n_levels - 1):
        skip = skips.pop()
        up = conv_transpose_output_shape(sizes, up_kernel, up_stride)
        # concat at min(up, skip) per axis — our Up top-left-crops both
        # operands to the common size (the reference, due to the bug noted in
        # models/unet.py, crops to min as well since it cats x with crop(x)).
        sizes = [min(u, s) for u, s in zip(up, skip)]
        sizes = list(conv_output_shape(sizes, kernel1))
        sizes = list(conv_output_shape(sizes, kernel2))
    return tuple(sizes)  # out_conv is 1x1 — no change


def unet_shrinkage(
    spatial: Sequence[int],
    **unet_kwargs,
) -> Tuple[int, ...]:
    """Total per-axis shrink (input - output) of the valid-conv U-Net."""
    out = unet_output_shape(spatial, **unet_kwargs)
    return tuple(s - o for s, o in zip(spatial, out))


def calculate_indexes(
    pad_size: int,
    eval_image_size: int,
    image_shape: int,
    padded_image_shape: int,
) -> List[List[int]]:
    """Overlapping tile windows for whole-volume evaluation.

    Bit-exact re-implementation of the reference tiling arithmetic
    (``hcat/utils.py:77-124``), quirks included, so that tile boundaries —
    and therefore every downstream voxel — land in identical positions:

    * whole-image shortcut when ``eval_image_size > image_shape`` returns
      ``[[0, image_shape]]`` (the *unpadded* extent);
    * interior windows are ``[z1, z1 + eval - 1 + 2*pad]`` (note the ``-1``);
    * a final right-aligned window ``[padded - (eval + 2*pad), padded - 1]``
      is always appended for coverage;
    * when no interior window fits, two overlapping windows
      ``[0, eval + 2*pad]`` and ``[padded - (eval + 2*pad), padded]`` are
      returned (no ``-1`` in this branch).
    """
    if eval_image_size > image_shape:
        return [[0, image_shape]]
    if eval_image_size <= 0:
        raise ValueError(
            f"calculate_indexes has incorrect values {pad_size} | "
            f"{image_shape} | {eval_image_size}"
        )
    starts = list(range(0, image_shape, eval_image_size))
    ind: List[List[int]] = []
    for i in range(1, len(starts)):
        z1 = starts[i - 1]
        z2 = starts[i] - 1 + 2 * pad_size
        if z2 < padded_image_shape:
            ind.append([z1, z2])
        else:
            break
    if not ind:
        width = eval_image_size + pad_size * 2
        ind.append([0, width])
        ind.append([padded_image_shape - width, padded_image_shape])
    else:
        width = eval_image_size + pad_size * 2
        ind.append([padded_image_shape - width, padded_image_shape - 1])
    return ind


def regular_tile_grid(
    image_shape: Sequence[int],
    tile_core: Sequence[int],
    halo: Sequence[int],
) -> Tuple[List[Tuple[int, ...]], Tuple[int, ...]]:
    """Static, regular tile grid for the fast batched inference path.

    Unlike :func:`calculate_indexes` (kept for reference parity), this grid is
    uniform: the image is conceptually padded by ``halo`` on every face plus
    right-padding up to a multiple of ``tile_core``; each tile input is
    ``tile_core + 2*halo`` and its valid output core is ``tile_core``.
    Uniform tiles mean one forward shape evaluates every tile and tiles
    stack into a batch — the throughput lever the reference's batch=1 loop
    (``hcat/segment.py:83-99``) leaves on the table.

    Returns ``(origins, padded_shape)`` where each origin is the tile's
    top-left corner in the padded image and ``padded_shape`` is the shape the
    image must be padded to.
    """
    nd = len(image_shape)
    tile_core = _as_tuple(tile_core, nd)
    halo = _as_tuple(halo, nd)
    n_tiles = [max(1, math.ceil(s / c)) for s, c in zip(image_shape, tile_core)]
    padded = tuple(
        n * c + 2 * h for n, c, h in zip(n_tiles, tile_core, halo)
    )
    origins: List[Tuple[int, ...]] = []

    def rec(axis: int, prefix: Tuple[int, ...]):
        if axis == nd:
            origins.append(prefix)
            return
        for i in range(n_tiles[axis]):
            rec(axis + 1, prefix + (i * tile_core[axis],))

    rec(0, ())
    return origins, padded


def crop_to(shape_from: Sequence[int], shape_to: Sequence[int]) -> Tuple[slice, ...]:
    """Top-left crop slices taking ``shape_from`` down to ``shape_to``.

    The reference crops top-left (``x[..., 0:n]``, not center crop) both in
    the model (``hcat/unet.py:335-338``) and the losses
    (``hcat/loss.py:50-56``); we preserve that convention.
    """
    for f, t in zip(shape_from, shape_to):
        if t > f:
            raise ValueError(f"cannot crop {shape_from} up to {shape_to}")
    return tuple(slice(0, t) for t in shape_to)
