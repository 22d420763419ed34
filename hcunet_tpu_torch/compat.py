"""``hcat``-compatible facade on the port's engines (twin of
``hcunet_tpu/compat.py``).

A user of the reference drives it as::

    from hcat import unet, rcnn, analyze
    from hcat import predict_segmentation_mask, predict_cell_candidates

This module gives the same names with the same call signatures and the
reference's torch array layout (``[B, C, X, Y(, Z)]`` channels-first, numpy
at the boundary), run by :mod:`hcunet_tpu_torch`.  (The repository's
``hcat`` package stays bound to the JAX facade; import this one as
``from hcunet_tpu_torch.compat import unet, rcnn, analyze``.)

The models are torch modules: ``unet`` and ``rcnn`` are built on
``device`` (CUDA unless the caller names another), ``.to()``/``.cuda()``/
``.cpu()`` move them, and every call runs where the model is.  The module
constants (``hcat/__init__.py:18-30``) keep their reference names,
including the ``__conectivity__`` spelling, and come from
:class:`WatershedConfig`.  The JAX facade's documented divergences stay:
``analyze`` returns all cells and writes ``./all_cells.pkl`` unless asked
not to.
"""

from __future__ import annotations

import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from hcunet_tpu_torch.config import (
    DetectorConfig,
    PipelineConfig,
    TileConfig,
    UNetConfig,
    WatershedConfig,
    resolve_device,
)
from hcunet_tpu_torch.core.precision import exact_float32

_WS = WatershedConfig()

# ``hcat/__init__.py:18-30``: the reference's config constants, same names
# (and the same ``conectivity`` typo), same values
__conectivity__ = _WS.connectivity
__compactness__ = _WS.compactness
__expand_mask__ = _WS.expand_mask
__expand_z__ = _WS.expand_z
__z_tolerance__ = _WS.z_tolerance
__mask_prob_threshold__ = _WS.mask_prob_threshold
__cell_prob_threshold__ = _WS.cell_prob_threshold


def _to_channels_last(x) -> np.ndarray:
    """[B, C, *spatial] (torch) -> [B, *spatial, C] (ours), as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.moveaxis(np.asarray(x), 1, -1)


def _to_channels_first(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.moveaxis(np.asarray(x), -1, 1)


def _is_checkpoint_zip(path: str) -> bool:
    """True for a checkpoint in the packages' zip format."""
    try:
        with zipfile.ZipFile(path) as z:
            return "variables.msgpack" in z.namelist()
    except zipfile.BadZipFile:
        return False


def _reference_unet_config(spec: Dict) -> UNetConfig:
    """The UNetConfig of a reference ``.unet`` blob's
    ``model_specifications`` (``hcat/unet.py:145-165``).  Weights in such a
    file were trained under the reference's swapped-args crop
    (``unet.py:311``), so ``reference_skip_bug`` is on."""
    kernel = spec["kernel"]
    if isinstance(kernel, dict):
        k1, k2 = tuple(kernel["conv1"]), tuple(kernel["conv2"])
    else:
        k1 = k2 = tuple(kernel)
    dil = spec["dilation"]
    if isinstance(dil, dict):
        dil = dil["conv1"]
    grp = spec["groups"]
    if isinstance(grp, dict):
        grp = grp["conv1"]
    up_stride = spec["upsample_stride"]
    if isinstance(up_stride, int):
        up_stride = (up_stride,) * spec["image_dimensions"]
    return UNetConfig(
        image_dimensions=spec["image_dimensions"],
        in_channels=spec["in_channels"],
        out_channels=spec["out_channels"],
        feature_sizes=tuple(spec["feature_sizes"]),
        kernel1=k1,
        kernel2=k2,
        upsample_kernel=tuple(spec["upsample_kernel"]),
        max_pool_kernel=tuple(spec["max_pool_kernel"]),
        upsample_stride=tuple(up_stride),
        dilation=dil if isinstance(dil, int) else 1,
        groups=grp if isinstance(grp, int) else 1,
        reference_skip_bug=True,
    )


class unet:
    """Drop-in spelling of ``hcat.unet`` (= ``Unet_Constructor``,
    ``hcat/unet.py:15-123``): the same constructor keyword arguments, the
    torch array layout, ``forward``/``train``/``eval``/``save``/``load``.

    The weights live in ``self.model``, the port's
    :class:`~hcunet_tpu_torch.models.unet.UNet` (the reference's
    state-dict names), He-normal from ``seed``, on ``device`` (CUDA unless
    given); ``.to()``/``.cuda()``/``.cpu()`` move it."""

    def __init__(
        self,
        image_dimensions: int = 2,
        in_channels: int = 3,
        out_channels: int = 2,
        feature_sizes=(32, 64, 128, 256, 512, 1024),
        kernel=(3, 3),
        upsample_kernel=(2, 2),
        max_pool_kernel=(2, 2),
        upsample_stride=2,
        dilation=1,
        groups=1,
        *,
        seed: int = 0,
        device=None,
    ):
        # the reference accepts each conv param as a value or a
        # {'conv1':…, 'conv2':…} dict (``unet.py:59-64``)
        if isinstance(kernel, dict):
            k1, k2 = tuple(kernel["conv1"]), tuple(kernel["conv2"])
        else:
            k1 = k2 = tuple(kernel)
        if isinstance(dilation, dict):
            dilation = dilation["conv1"]
        if isinstance(groups, dict):
            groups = groups["conv1"]
        if isinstance(upsample_stride, int):
            upsample_stride = (upsample_stride,) * image_dimensions
        cfg = UNetConfig(
            image_dimensions=image_dimensions,
            in_channels=in_channels,
            out_channels=out_channels,
            feature_sizes=tuple(feature_sizes),
            kernel1=k1,
            kernel2=k2,
            upsample_kernel=tuple(upsample_kernel),
            max_pool_kernel=tuple(max_pool_kernel),
            upsample_stride=tuple(upsample_stride),
            dilation=int(dilation),
            groups=int(groups),
        )
        self.device = resolve_device(device)
        self._build(cfg, seed=seed)
        self._training = False

    def _build(self, cfg: UNetConfig, seed: int = 0, state_dict=None):
        from hcunet_tpu_torch.models.unet import UNet, init_unet

        self.config = cfg
        if state_dict is None:
            self.model = init_unet(cfg, torch.Generator().manual_seed(seed))
        else:
            self.model = UNet(cfg)
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @property
    def variables(self) -> Dict:
        """The weights as the JAX package's ``{"params", "batch_stats"}``
        tree (numpy leaves)."""
        from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict

        return jax_variables_from_unet_state_dict(self.model.state_dict(), self.config)

    # -- torch-Module surface ------------------------------------------------

    @exact_float32()
    def forward(self, x) -> np.ndarray:
        """``x``: [B, C, X, Y(, Z)] (numpy or tensor) → numpy of the
        valid-conv output, same layout, computed on the model's device.  In
        ``train()`` mode the batch-norm running statistics update, as in a
        torch forward."""
        t = torch.from_numpy(np.ascontiguousarray(_to_channels_last(x), np.float32))
        self.model.train(self._training)
        with torch.no_grad():
            out = self.model(t.to(self.device))
        self.model.eval()
        return _to_channels_first(out)

    __call__ = forward

    def train(self, mode: bool = True):
        self._training = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def to(self, device=None):
        if device is not None:
            self.device = resolve_device(device)
            self.model.to(self.device)
        return self

    def cuda(self, device=None):
        return self.to("cuda" if device is None else device)

    def cpu(self):
        return self.to("cpu")

    # -- checkpointing (``unet.py:145-196``) ---------------------------------

    def save(self, filename: str, hyperparameters: Optional[Dict] = None):
        """A checkpoint in the packages' zip format (msgpack weights, config,
        source snapshot; no pickle), which the JAX facade also loads."""
        from hcunet_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(filename, self.variables, self.config,
                        hyperparameters=hyperparameters)

    def load(self, filename: str, to_cuda: bool = True):
        """Rebuild the architecture from the stored spec, then restore the
        weights.  Reads the packages' zip checkpoints and the reference's
        ``.unet`` files (a ``torch.save`` of ``{'state_dict',
        'model_specifications', 'hyperparameters', ...}``, read with
        ``weights_only=True``; its state dict loads as it is, since the port
        keeps the reference's names).  Returns the stored
        hyperparameters, like ``unet.py:167-196``.  ``to_cuda`` is accepted
        for the reference's signature; the model stays on ``self.device``."""
        del to_cuda
        if _is_checkpoint_zip(filename):
            from hcunet_tpu_torch.utils.checkpoint import load_checkpoint
            from hcunet_tpu_torch.utils.port_jax import unet_state_dict_from_jax_variables

            cfg, variables, hyper = load_checkpoint(filename)
            state_dict = unet_state_dict_from_jax_variables(variables, cfg)
        else:
            blob = torch.load(filename, map_location="cpu", weights_only=True)
            cfg = _reference_unet_config(blob["model_specifications"])
            state_dict = blob["state_dict"]
            hyper = blob.get("hyperparameters")
        self._build(cfg, state_dict=state_dict)
        self._training = False
        return hyper

    def _apply(self):
        """The eval forward on a tile batch ``[B, *tile, C]`` on the model's
        device, for the tiled engines: the BN-folded serving forward
        (:func:`~hcunet_tpu_torch.infer.compile.compile_serving_apply`) in
        the model's dtype, on the weights as they are now, as the command
        line serves a checkpoint.  (The JAX facade runs the plain apply;
        the two differ by the folding's rounding.)"""
        from hcunet_tpu_torch.infer.compile import compile_serving_apply

        return compile_serving_apply(self.model, dtype=self.model.dtype, device=self.device)


class _CompatRCNN:
    """torchvision-contract detector: ``model(images)`` → list of
    ``{'boxes' [N,4], 'labels' [N], 'scores' [N]}`` with boxes in image
    axes (x = width), what ``hcat/segment.py:192-199`` consumes."""

    def __init__(self, detector):
        self.detector = detector

    @exact_float32()
    def __call__(self, images) -> List[Dict[str, np.ndarray]]:
        if isinstance(images, (list, tuple)):
            arr = np.stack([np.asarray(torch.as_tensor(im).cpu(), np.float32) for im in images])
        else:
            arr = np.asarray(torch.as_tensor(images).cpu(), np.float32)
        if arr.ndim != 4:
            raise ValueError(f"expected [B, 3, H, W] images, got {arr.shape}")
        out = self.detector.detect(np.ascontiguousarray(_to_channels_last(arr)))
        boxes, scores, labels, valid = (
            out[k].cpu().numpy() for k in ("boxes", "scores", "labels", "valid")
        )
        return [
            {
                "boxes": boxes[b][valid[b]].astype(np.float32),
                "labels": labels[b][valid[b]].astype(np.int64),
                "scores": scores[b][valid[b]].astype(np.float32),
            }
            for b in range(arr.shape[0])
        ]

    def eval(self):
        return self

    def train(self, mode: bool = True):  # torchvision-detector parity
        if mode:
            raise ValueError(
                "compat rcnn serves inference; use "
                "hcunet_tpu_torch.train.detection_trainer for training"
            )
        return self

    def to(self, device=None):
        if device is not None:
            self.detector.device = resolve_device(device)
            self.detector.to(self.detector.device)
        return self

    def cuda(self, device=None):
        return self.to("cuda" if device is None else device)

    def cpu(self):
        return self.to("cpu")


def rcnn(path: Optional[str] = None, *, config: Optional[DetectorConfig] = None,
         backbone: str = "resnet50", seed: int = 0, image_hw=(512, 512), device=None):
    """``hcat.rcnn`` (``hcat/rcnn.py:7-21``): the production detection head
    on ``device`` (CUDA unless given), optionally restored from ``path``.

    ``path`` takes the packages' detector checkpoints or a torchvision
    ``fasterrcnn_resnet50_fpn`` ``.pth`` state dict (the reference's
    format), which loads as it is: the port keeps torchvision's names.
    Without ``path`` the weights are torch's default initialisation drawn
    from ``seed``; ``image_hw`` is accepted for the JAX facade's signature
    (a torch module needs no input shape to initialise)."""
    from hcunet_tpu_torch.models.detection import Detector

    del image_hw
    cfg = config or DetectorConfig()
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        det = Detector(cfg, backbone=backbone, device="cpu")
    if path is not None:
        if _is_checkpoint_zip(path):
            from hcunet_tpu_torch.utils.checkpoint import load_checkpoint
            from hcunet_tpu_torch.utils.port_jax import detector_state_dict_from_jax_variables

            _cfg, variables, _h = load_checkpoint(path)
            det.load_state_dict(detector_state_dict_from_jax_variables(variables, backbone))
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            # older torchvision names the RPN conv without the Conv2dNormActivation wrapper
            sd = {k.replace("rpn.head.conv.weight", "rpn.head.conv.0.0.weight")
                  .replace("rpn.head.conv.bias", "rpn.head.conv.0.0.bias"): v
                  for k, v in sd.items()}
            missing, _unexpected = det.load_state_dict(sd, strict=False)
            missing = [k for k in missing if not k.endswith("num_batches_tracked")]
            if missing:
                raise KeyError(f"{path}: no weights for {missing[:5]} ...")
    det.device = dev
    det.to(dev)
    return _CompatRCNN(det)


@exact_float32()
def predict_segmentation_mask(unet_model, image, device=None,
                              use_probability_map: bool = False,
                              mask_cell_prob_threshold: float = 0.5,
                              *, tile_cfg: Optional[TileConfig] = None):
    """``hcat.predict_segmentation_mask`` (``hcat/segment.py:21-136``):
    tiled semantic segmentation of a whole ``[1, C, X, Y, Z]`` volume on
    ``device`` (where the model is, unless given; a given device moves the
    model there, as the reference's ``unet.to(device)`` does).  The tile
    geometry comes from :func:`auto_tile_config` unless ``tile_cfg`` is
    given.  Returns numpy ``[1, 1, X, Y, Z]``: float32 probabilities when
    ``use_probability_map`` else uint8 {0, 1}."""
    from hcunet_tpu_torch.config import auto_tile_config, device_hbm_bytes
    from hcunet_tpu_torch.infer import tiling

    if device is not None:
        unet_model.to(device)
    cfg, dev = unet_model.config, unet_model.device
    vol = _to_channels_last(image).astype(np.float32)
    out = tiling.predict_segmentation_mask(
        unet_model._apply(), vol, cfg,
        tile_cfg or auto_tile_config(cfg, hbm_bytes=device_hbm_bytes(dev)),
        use_probability_map=use_probability_map,
        mask_cell_prob_threshold=mask_cell_prob_threshold,
        device=dev,
    )
    return _to_channels_first(out)


@exact_float32()
def predict_cell_candidates(image, model, candidate_list=None,
                            initial_coords=(0, 0)) -> Dict[str, np.ndarray]:
    """``hcat.predict_cell_candidates`` (``hcat/segment.py:139-218``):
    per-z-plane tiled detection over a ``[1, C>=3, X, Y, Z]`` volume on the
    detector's device, NMS-merged into ``candidate_list``; boxes in array
    axes with a per-box ``z_level``, the contract the instance stage
    consumes."""
    from hcunet_tpu_torch.infer import detect
    from hcunet_tpu_torch.infer.candidates import merge_cell_candidates

    vol = _to_channels_last(image).astype(np.float32)[0]  # [X, Y, Z, C]
    new = detect.predict_cell_candidates(
        vol, model.detector, initial_coords=initial_coords, device=model.detector.device
    )
    if candidate_list is not None and len(candidate_list.get("scores", [])):
        # reference merge semantics (``utils.py:336-366``): the new boxes
        # were already offset by initial_coords above
        return merge_cell_candidates(candidate_list, new)
    return new


def generate_unique_segmentation_mask_from_probability(
    predicted_semantic_mask: np.ndarray,
    predicted_cell_candidate_list: Dict[str, np.ndarray],
    image=None,
    cell_prob_threshold: float = __cell_prob_threshold__,
    mask_prob_threshold: float = __mask_prob_threshold__,
):
    """``hcat.generate_unique_segmentation_mask_from_probability``
    (``hcat/segment.py:221-505``): detection-seeded instance watershed on
    the host (the default ``fused`` flood).  ``image`` is accepted for
    signature parity.  Returns ``(unique_mask, seed)``."""
    from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask

    del image
    sem = np.asarray(predicted_semantic_mask)
    while sem.ndim > 3:  # accept [1, 1, X, Y, Z] / [1, X, Y, Z]
        sem = sem[0]
    cfg = WatershedConfig(
        cell_prob_threshold=cell_prob_threshold,
        mask_prob_threshold=mask_prob_threshold,
    )
    return generate_unique_segmentation_mask(
        np.ascontiguousarray(sem), predicted_cell_candidate_list, cfg
    )


def generate_cell_objects(image, unique_mask, cell_candidates=None,
                          x_ind_chunk: int = 0, y_ind_chunk: int = 0):
    """``hcat.generate_cell_objects`` (``hcat/segment.py:508-560``): one
    :class:`HairCell` per instance label.  ``image`` is the torch-layout
    ``[B, C, X, Y, Z]`` chunk; ``cell_candidates`` is accepted for
    signature parity (unused, as in the reference)."""
    from hcunet_tpu_torch.analysis.haircell import generate_cell_objects as _gen

    del cell_candidates
    vol = _to_channels_last(image)[0]  # [X, Y, Z, C]
    return _gen(vol, np.asarray(unique_mask),
                x_ind_chunk=x_ind_chunk, y_ind_chunk=y_ind_chunk)


@exact_float32()
def analyze(path=None, numchunks: int = 3, save_plots: bool = False,
            show_plots: bool = False, path_chunk_storage: Optional[str] = None,
            *, unet_model: Optional[unet] = None, faster_rcnn=None,
            volume: Optional[np.ndarray] = None,
            tiles: Optional[TileConfig] = None,
            watershed: Optional[WatershedConfig] = None,
            fit_cochlea: bool = True,
            write_all_cells_pkl: bool = True):
    """``hcat.analyze`` (``hcat/main.py:20-236``) with the reference's
    signature and return contract ``(mask, unique_mask, cell_list)``; the
    masks come back ``[1, 1, X, Y, Z]`` like the reference's
    ``reconstruct_mask`` (``hcat/utils.py:279``).  It runs on the U-Net's
    device.

    The reference hard-codes its checkpoint paths (``main.py:57-66``); pass
    the models instead: ``unet_model`` (a :class:`unet`) and optionally
    ``faster_rcnn`` (from :func:`rcnn`).  ``show_plots`` is accepted and
    ignored (headless); ``save_plots`` writes the size-QA tif.

    Divergences, as in the JAX facade: the returned cell list is all
    cells (the reference returns the last chunk's, ``main.py:156,236``),
    and the full list is pickled to ``./all_cells.pkl`` in the current
    directory (``main.py:219``, which ``loop_main.py:58`` reads) unless
    ``write_all_cells_pkl=False``.
    """
    from hcunet_tpu_torch.config import auto_tile_config, device_hbm_bytes
    from hcunet_tpu_torch.infer.pipeline import analyze as _analyze

    del show_plots
    if path_chunk_storage is None:
        # the reference raises NotADirectoryError here (``main.py:22-23``)
        raise NotADirectoryError("Specify a path to chunk storage.")
    if unet_model is None:
        raise ValueError(
            "pass unet_model= (the reference hard-codes its checkpoint "
            "path at hcat/main.py:57; this facade takes the model instead)"
        )
    dev = unet_model.device
    res = _analyze(
        path=path, volume=volume, unet_apply=unet_model._apply(),
        detector=None if faster_rcnn is None else faster_rcnn.detector,
        cfg=PipelineConfig(
            numchunks=numchunks, unet=unet_model.config,
            tiles=tiles or auto_tile_config(unet_model.config, hbm_bytes=device_hbm_bytes(dev)),
            watershed=watershed or WatershedConfig(),
        ),
        work_dir=path_chunk_storage, save_plots=save_plots,
        fit_cochlea=fit_cochlea, device=dev,
    )
    if write_all_cells_pkl:
        # the reference pickles the accumulated cell list to ./all_cells.pkl
        # in the current directory (``main.py:219``); the batch loop
        # (``loop_main.py:58-59``) reloads it for CSV export
        import pickle

        with open("all_cells.pkl", "wb") as f:
            pickle.dump(res.cells, f)
    return (
        np.asarray(res.mask)[None, None],
        np.asarray(res.unique_mask)[None, None],
        res.cells,
    )


__all__ = [
    "unet",
    "rcnn",
    "analyze",
    "predict_segmentation_mask",
    "predict_cell_candidates",
    "generate_unique_segmentation_mask_from_probability",
    "generate_cell_objects",
    "__conectivity__",
    "__compactness__",
    "__expand_mask__",
    "__expand_z__",
    "__z_tolerance__",
    "__mask_prob_threshold__",
    "__cell_prob_threshold__",
]
