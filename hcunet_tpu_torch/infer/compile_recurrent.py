"""Serving forward of the recurrent family, twin of
``hcunet_tpu/infer/compile_recurrent.py``.

:func:`compile_recurrent_apply` builds the BN-folded inference forward of a
:class:`~hcunet_tpu_torch.models.runet.RecursiveUNet` (and hands an
:class:`~hcunet_tpu_torch.models.rdcnet.RDCNet` to
:func:`compile_rdcnet_apply`), equal to the model's eval forward up to
BN-folding rounding:

* every ``SameConvBNRelu`` is folded once, on the host, in float32;
* every stride-1 conv is a same-padding conv
  (:func:`~hcunet_tpu_torch.ops.conv.conv_same`): kernel K1 given the
  zero padding as ``padding=`` (``conv``,
  :func:`~hcunet_tpu_torch.ops.conv.conv3d_valid` by default),
  with the bias and, where the forward applies one, the ReLU in K1's
  epilogue: 20 launches per RecursiveUNet timestep, 7 per RDCNet iteration
  and one for its output conv;
* with ``subpixel_tconv=True`` (the default, as in JAX) the RecursiveUNet's
  (6, 6, 5)/(2, 2, 1) transposed convs with padding 2 run as their four
  parity convs stacked along Cout, one K1 launch each
  (:func:`~hcunet_tpu_torch.infer.compile.tconv_subpixel`), else as
  ``F.conv_transpose3d``;
* RDCNet's stride-2 input conv and its (4, 4, 4)/(2, 2, 2) transposed conv
  stay plain PyTorch, as the JAX package left them to XLA;
* ``split_x=n`` at B=1 runs the volume as ``n`` overlapping x-tiles batched
  on the leading axis, refreshing the carried states' seam columns at every
  step (:func:`_halo_refresh`), with the JAX function's eligibility rules
  and default halos.

The JAX function's z-block lane packing (``zb_for``, ``zb_plan``,
``zb_cap``) was sized for the TPU's 128-lane matrix unit and is not carried
over, nor are its arguments.  With ``mesh=`` the ``split_x`` tiles are
spread over the mesh's devices, each timestep's seam refresh copying the
columns each tile needs from its neighbours' devices.  The returned
forwards run float32 with TF32 off
(:func:`~hcunet_tpu_torch.core.precision.exact_float32`).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import torch

from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig, resolve_device
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.infer.compile import (
    _folded_conv_params,
    subpixel_pads,
    subpixel_tconv_weights,
    tconv_subpixel,
)
from hcunet_tpu_torch.models.rdcnet import DILATIONS
from hcunet_tpu_torch.models.runet import UP_PADDING
from hcunet_tpu_torch.models.unet import conv_weight_channels_last, tconv_weight_channels_last
from hcunet_tpu_torch.parallel.mesh import canonical_device
from hcunet_tpu_torch.ops.conv import conv3d_valid, conv_same, conv_transpose_torch, max_pool
from hcunet_tpu_torch.utils.logging import get_logger
from hcunet_tpu_torch.utils.profiling import span

log = get_logger(__name__)

_Conv = Tuple[torch.Tensor, torch.Tensor]  # weights [*k, Cin, Cout] in dtype, float32 bias

# the families' default halos: RecursiveUNet full-resolution columns (>= the
# measured one-step receptive radius 28 of the k=3 geometry), RDCNet
# half-resolution columns (>= the widest dilated tap's reach, 2 * 5)
RUNET_HALO = 32
RDCNET_HALO = 12


def _split_offsets(n: int, core: int, tile: int) -> List[int]:
    """Global start column of each tile window.  Tiles 0 and n-1 start flush
    with the true volume edges (so the same-padding convs' zero padding
    matches the unsplit forward at every layer); interior tiles center their
    halos around their owned core."""
    X = n * core
    return [0] + [i * core - (tile - core) // 2 for i in range(1, n - 1)] + (
        [X - tile] if n > 1 else []
    )


def _tile_core(n: int, tile: int, halo: int) -> int:
    return tile - (2 * halo if n >= 3 else halo)


def _halo_refresh(arr: torch.Tensor, halo: int) -> torch.Tensor:
    """Refresh the seam halos of a volume split into ``n`` x-tiles
    ``arr[j]`` (:func:`_refresh_tiles` on one device)."""
    return torch.stack(_refresh_tiles(list(arr.unbind(0)), halo), dim=0)


def _refresh_tiles(tiles: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Refresh the seam halos of ``n`` x-tiles, each on its own device.

    ``tiles[j]`` holds global columns ``[offs[j], offs[j] + tile)`` where
    tile ``j`` owns ``[j * core, (j + 1) * core)``; ``tile = core + halo``
    at n = 2 and ``core + 2 halo`` at n >= 3.  Every column a tile holds but
    does not own is overwritten with its owner's value at the same global
    position, copied from the owner's device.  Owned columns sit >=
    ``halo`` from every cut edge, so they stay exact as long as ``halo``
    covers one step's receptive radius."""
    n, tile = len(tiles), int(tiles[0].shape[0])
    core = _tile_core(n, tile, halo)
    offs = _split_offsets(n, core, tile)

    def owned(g0: int, g1: int, dev) -> List[torch.Tensor]:
        segs, g = [], g0
        while g < g1:
            j = min(g // core, n - 1)
            g2 = min(g1, (j + 1) * core) if j < n - 1 else g1
            segs.append(tiles[j][g - offs[j]: g2 - offs[j]].to(dev, non_blocking=True))
            g = g2
        return segs

    out = []
    for j in range(n):
        o0, o1 = j * core, (j + 1) * core
        dev = tiles[j].device
        segs = owned(offs[j], o0, dev) + [tiles[j][o0 - offs[j]: o1 - offs[j]]]
        segs += owned(o1, offs[j] + tile, dev)
        out.append(torch.cat(segs, dim=0) if len(segs) > 1 else segs[0])
    return out


class _MeshTiles:
    """The ``n`` x-tiles of a split volume grouped by device: tiles ``k *
    n/size .. (k+1) * n/size - 1`` batched on device ``k`` of the mesh
    (:func:`~hcunet_tpu_torch.parallel.mesh.tiles_sharding`)."""

    def __init__(self, mesh, n: int):
        from hcunet_tpu_torch.parallel.mesh import tiles_sharding

        self.devices = tiles_sharding(mesh, n).devices
        self.per = n // len(self.devices)

    def place(self, stacked: torch.Tensor) -> List[torch.Tensor]:
        """``[n, tile, ...]`` -> one ``[n/size, tile, ...]`` group per device."""
        return [g.to(d, non_blocking=True)
                for g, d in zip(stacked.split(self.per), self.devices)]

    def refresh(self, groups: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
        tiles = _refresh_tiles([t for g in groups for t in g.unbind(0)], halo)
        return [torch.stack(tiles[k * self.per: (k + 1) * self.per])
                for k in range(len(groups))]

    def gather(self, groups: List[torch.Tensor], device) -> torch.Tensor:
        return torch.cat([g.to(device, non_blocking=True) for g in groups], dim=0)


def _split_stack(vol: torch.Tensor, n: int, tile: int, core: int) -> torch.Tensor:
    """``[X, ...]`` volume -> ``[n, tile, ...]`` overlapping x-tiles."""
    return torch.stack([vol[o: o + tile] for o in _split_offsets(n, core, tile)], dim=0)


def _split_unstack(arr: torch.Tensor, halo: int) -> torch.Tensor:
    """``[n, tile, ...]`` tiles -> ``[1, X, ...]``: each tile cropped to its
    owned core, concatenated."""
    n, tile = int(arr.shape[0]), int(arr.shape[1])
    core = _tile_core(n, tile, halo)
    segs = [arr[0, :core]] + [arr[j, halo: halo + core] for j in range(1, n - 1)]
    segs.append(arr[n - 1, tile - core:])
    return torch.cat(segs, dim=0)[None]


def _split_geometry(n: int, width: int, halo: int) -> Optional[Tuple[int, int]]:
    """``(core, tile)`` of an ``n``-way split of ``width`` columns with seam
    halo ``halo``, or None where the JAX function runs unsplit: ``n < 2``,
    no halo, ``width`` not a multiple of ``n``, or a core narrower than its
    tile's halos."""
    if n < 2 or halo <= 0 or width % n:
        return None
    core = width // n
    need = 2 * halo if n >= 3 else halo
    return (core, core + need) if core >= need else None


def _conv_params(module, dtype, device, transposed: bool = False) -> _Conv:
    to_last = tconv_weight_channels_last if transposed else conv_weight_channels_last
    w = to_last(module.weight).detach().float()
    return (
        w.to(device=device, dtype=dtype).contiguous(),
        module.bias.detach().float().to(device).contiguous(),
    )


def _plain_apply(model, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The model's own eval forward on ``device`` (a copy of it, made at
    the first call), float32 out: the fallback where the serving forward
    does not apply."""
    plain = []

    @exact_float32()
    @torch.no_grad()
    def apply_fn(image: torch.Tensor) -> torch.Tensor:
        if not plain:
            plain.append(copy.deepcopy(model).to(device).eval())
        return plain[0](image.to(device)).float()

    return apply_fn


def compile_recurrent_apply(
    model,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    conv: Callable = conv3d_valid,
    subpixel_tconv: bool = True,
    split_x: int = 1,
    halo_x: Optional[int] = None,
    mesh=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the BN-folded inference forward of a ``RecursiveUNet``.

    Returns ``apply(image[B, X, Y, Z, C]) -> s_T`` (float32) on ``device``
    (CUDA unless given; with a ``mesh``, its first device).  ``conv`` runs
    the valid convs with the signature of
    :func:`~hcunet_tpu_torch.ops.conv.conv3d_valid`, ``padding=``
    included; K1 by default.  An
    ``RDCNet`` goes to :func:`compile_rdcnet_apply` (``halo_x`` in its
    half-resolution columns, default 12).  Falls back to the model's plain
    forward where the JAX function does: a pool or upsample stride other
    than (2, 2, 1), an even conv kernel, and at call time x or y not
    divisible by 4.

    ``split_x=n`` (B=1 only): the volume runs as ``n`` overlapping x-tiles
    batched on the leading axis, exchanging ``halo_x`` (default 32)
    full-resolution seam columns of the state and ``halo_x / 2`` of the
    half-resolution gate state at every timestep.  It needs the (3, 3, 3)
    kernel (the halo covers that geometry's receptive radius, 28), ``X %
    n == 0``, core and halo multiples of 4, and a core at least the tile's
    halos; otherwise the volume runs unsplit.  The output equals the
    unsplit forward's where the conv computes each output voxel the same
    way at any batch index and position.

    ``mesh`` (with ``split_x`` a multiple of ``mesh.size``): the tiles
    spread over the mesh's devices, ``n / size`` batched on each, with the
    folded weights placed on every device; each timestep's refresh of both
    carries copies the seam columns between neighbouring devices.  The
    output equals the ``split_x=n`` forward without a mesh where the conv
    computes each voxel the same way at any batch size."""
    dev = _first_device(device, mesh)
    cfg = model.config
    if isinstance(cfg, RDCNetConfig):
        return compile_rdcnet_apply(
            model, dtype=dtype, device=dev, conv=conv, split_x=split_x,
            halo_x=RDCNET_HALO if halo_x is None else int(halo_x), mesh=mesh,
        )
    plain = _plain_apply(model, dev)
    if (
        not isinstance(cfg, RUNetConfig)
        or tuple(cfg.max_pool_kernel) != (2, 2, 1)
        or tuple(cfg.upsample_stride) != (2, 2, 1)
        or any(k % 2 == 0 for k in cfg.kernel)
    ):
        log.warning(
            "compile_recurrent_apply: %s geometry has no serving forward; "
            "running the model's plain forward", type(cfg).__name__,
        )
        return plain

    halo = RUNET_HALO if halo_x is None else int(halo_x)
    c1 = cfg.channels[1]
    skip_bug = bool(model.reference_skip_bug)
    pads = tuple((k - 1) // 2 for k in cfg.kernel)
    use_subpixel = subpixel_tconv and subpixel_pads(cfg.upsample_kernel, UP_PADDING) is not None
    pool = tuple(cfg.max_pool_kernel)

    def params_on(d) -> dict:
        """The folded weights on device ``d``."""
        P = {
            name: [
                _folded_conv_params(block.conv1, block.batch1, 1, dtype, d),
                _folded_conv_params(block.conv2, block.batch2, 1, dtype, d),
            ]
            for name, block in model.named_children()
            if name.startswith(("down", "up"))
        }
        for name in ("up1_fh", "up1_fz", "up2"):
            w_up, b_up = _conv_params(getattr(model, name).up_conv, torch.float32, "cpu", True)
            if use_subpixel:
                w_up, b_up = subpixel_tconv_weights(w_up), b_up.repeat(4)
            P["tconv_" + name] = (w_up.to(device=d, dtype=dtype).contiguous(), b_up.to(d))
        P["out"] = _conv_params(model.out_conv, dtype, d)
        return P

    placed = _PerDevice(params_on, dev)

    def same(x, params: _Conv, relu=True, padding=pads):
        return conv_same(x, *params, padding=padding, relu=relu, accum_dtype=dtype, conv=conv)

    def block(x, P, name: str):
        for params in P[name]:
            x = same(x, params)
        return x

    def tconv(x, P, name: str):
        w, b = P["tconv_" + name]
        if use_subpixel:
            return tconv_subpixel(x, w, b, conv, pad=UP_PADDING)
        return conv_transpose_torch(
            x, w, b, stride=cfg.upsample_stride, padding=UP_PADDING, accum_dtype=dtype
        )

    def join(x, skip):
        return torch.cat([x, x if skip_bug else skip], dim=-1)

    def gate(x, P, br: str):
        b = block(x, P, f"down2_{br}")
        x = block(max_pool(b, pool), P, f"down3_{br}")
        return block(join(tconv(x, P, f"up1_{br}"), b), P, f"up1_{br}")

    def timestep(image, s, h):
        P = placed[image.device]
        a = block(torch.cat([image, s], dim=-1), P, "down1")
        x = max_pool(a, pool)
        hh = torch.tanh(gate(x, P, "fh"))
        z = torch.sigmoid(gate(x, P, "fz"))
        h = h * z + (-1.0 * z * hh)  # r_unet.py:155, verbatim
        x = block(join(tconv(h, P, "up2"), a), P, "up2")
        return same(x, P["out"], relu=False, padding=0), h

    @exact_float32()
    @torch.no_grad()
    def apply_fn(image: torch.Tensor) -> torch.Tensor:
        with span("hcunet.recurrent.forward"):
            return forward(image)

    def forward(image: torch.Tensor) -> torch.Tensor:
        B, X, Y, Z, _ = image.shape
        if X % 4 or Y % 4:
            return plain(image)
        with span("hcunet.recurrent.upload"):
            image = image.to(device=dev, dtype=dtype).contiguous()
        n = int(split_x)
        geo = _split_geometry(n, X, halo) if B == 1 else None
        use_split = (
            geo is not None
            and tuple(cfg.kernel) == (3, 3, 3)  # the halo is sized for this radius
            and halo % 4 == 0
            and geo[0] % 4 == 0
        )
        if use_split:
            core, tile = geo
            image = _split_stack(image[0], n, tile, core)
            B, X = n, tile
        groups = _MeshTiles(mesh, n) if use_split and mesh is not None else None
        images = groups.place(image) if groups else [image]
        s = [torch.zeros((*im.shape[:4], cfg.out_channels), dtype=dtype, device=im.device)
             for im in images]
        h = [torch.ones((im.shape[0], X // 2, Y // 2, Z, c1), dtype=dtype, device=im.device)
             for im in images]
        for _ in range(cfg.timesteps):
            with span("hcunet.recurrent.timestep"):
                if groups:
                    s, h = groups.refresh(s, halo), groups.refresh(h, halo // 2)
                elif use_split:
                    s, h = [_halo_refresh(s[0], halo)], [_halo_refresh(h[0], halo // 2)]
                s, h = (list(t) for t in zip(*(timestep(im, s_k, h_k)
                                               for im, s_k, h_k in zip(images, s, h))))
        out = groups.gather(s, dev) if groups else s[0]
        if use_split:
            out = _split_unstack(out, halo)
        return out.float()

    return apply_fn


def _first_device(device, mesh) -> torch.device:
    """The forward's device: ``device``, else the mesh's first device, else
    CUDA."""
    if device is None and mesh is not None:
        device = mesh.devices.flat[0]
    return resolve_device(device)


class _PerDevice(dict):
    """``params_on(d)`` for each device ``d`` asked for, built at the first
    ask (``home``'s at once)."""

    def __init__(self, params_on, home):
        super().__init__()
        self.params_on = params_on
        self[canonical_device(home)] = params_on(home)

    def __missing__(self, d):
        d = canonical_device(d)
        if d not in self:
            self[d] = self.params_on(d)
        return self[d]


def compile_rdcnet_apply(
    model,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    conv: Callable = conv3d_valid,
    split_x: int = 1,
    halo_x: int = RDCNET_HALO,
    mesh=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The inference forward of an ``RDCNet``: ``apply(image[B, X, Y, Z,
    C]) -> [B, X', Y', Z', out_channels]`` (float32) on ``device`` (CUDA
    unless given; with a ``mesh``, its first device), equal to the model's
    eval forward at the same ``dtype`` up to rounding.  The recurrence runs
    in ``dtype`` at half resolution: per iteration the 1×1×1 squeeze, the
    five dilated 5³ convs and the 1×1×1 merge, each a ``conv`` launch (K1
    by default); then the 3³ output conv, also K1.  The stride-2 input conv
    and the transposed conv stay plain PyTorch.

    ``split_x=n`` (B=1 only): the recurrence runs as ``n`` overlapping
    x-tiles of the half-resolution features, split after the input conv
    (so they are exact by construction), and only the carried ``y``
    exchanges ``halo_x`` (default 12 >= the widest dilated tap's reach, 10)
    seam columns per iteration; the output conv and the transposed conv
    run on the reassembled tensor.  It needs the half-resolution width to
    be a multiple of ``n`` and a core at least the tile's halos; otherwise
    the recurrence runs unsplit.  ``mesh``: the tiles spread over its
    devices as in :func:`compile_recurrent_apply`, the recurrence's weights
    placed on each."""
    dev = _first_device(device, mesh)
    cfg: RDCNetConfig = model.config
    blk = model.RDCblock
    w_in, b_in = _conv_params(model.strided_conv, dtype, dev)
    out = _conv_params(model.out_conv, dtype, dev)
    w_up, b_up = _conv_params(model.transposed_conv, dtype, dev, transposed=True)

    def params_on(d) -> dict:
        """The recurrence's weights on device ``d``."""
        return {
            "squeeze": _conv_params(blk.conv, dtype, d),
            "dilated": [_conv_params(getattr(blk.grouped_conv, f"conv{k}"), dtype, d)
                        for k in DILATIONS],
            "merge": _conv_params(blk.grouped_conv.out_conv, dtype, d),
        }

    placed = _PerDevice(params_on, dev)

    def same(x, params: _Conv, padding=0, dilation=1):
        return conv_same(x, *params, padding=padding, dilation=dilation, accum_dtype=dtype,
                         conv=conv)

    def iteration(x, y):
        P = placed[x.device]
        sq = same(torch.cat([x, y], dim=-1), P["squeeze"])
        outs = [same(sq, p, padding=2 * d, dilation=d) for d, p in zip(DILATIONS, P["dilated"])]
        return same(torch.cat(outs, dim=-1), P["merge"]) + y

    @exact_float32()
    @torch.no_grad()
    def apply_fn(image: torch.Tensor) -> torch.Tensor:
        image = image.to(device=dev, dtype=dtype).contiguous()
        x = conv_same(image, w_in, b_in, stride=2, padding=1, accum_dtype=dtype)
        n = int(split_x)
        geo = _split_geometry(n, int(x.shape[1]), int(halo_x)) if x.shape[0] == 1 else None
        if geo is not None:
            core, tile = geo
            x = _split_stack(x[0], n, tile, core)
        groups = _MeshTiles(mesh, n) if geo is not None and mesh is not None else None
        xs = groups.place(x) if groups else [x]
        ys = [torch.zeros_like(x_k) for x_k in xs]
        for _ in range(cfg.timesteps):
            if groups:
                ys = groups.refresh(ys, int(halo_x))
            elif geo is not None:
                ys = [_halo_refresh(ys[0], int(halo_x))]
            ys = [iteration(x_k, y_k) for x_k, y_k in zip(xs, ys)]
        y = groups.gather(ys, dev) if groups else ys[0]
        if geo is not None:
            y = _split_unstack(y, int(halo_x))
        y = same(y, out, padding=1)
        return conv_transpose_torch(y, w_up, b_up, stride=2, padding=1).float()

    return apply_fn
