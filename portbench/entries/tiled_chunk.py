"""Entry ``tiled_chunk``: ``analyze``'s segmentation stage on a chunk that
is already on the card.

The program: the U-Net of the configuration with the benchmark's weights,
its BN-folded serving forward (``infer/compile.py::compile_serving_apply``)
in the mix's dtype, and ``infer/tiling.py::predict_segmentation_mask``
over the normalized ``[1, X, Y, Z, 4]`` volume, as a probability map.  A
request returns once a checksum of the map is on the host.  The pool's
volumes are made on the card before the window; the check compares every
voxel of each sampled request's map with the reference's.
"""

from __future__ import annotations

import torch

from portbench import flops
from portbench.inputs import make_volume
from portbench.reference.precision import Precision


def unet_config(cfg: dict):
    from hcunet_tpu_torch.config import UNetConfig

    keys = ("image_dimensions", "in_channels", "out_channels", "kernel1", "kernel2",
            "upsample_kernel", "max_pool_kernel", "upsample_stride", "dilation", "groups",
            "reference_skip_bug")
    return UNetConfig(feature_sizes=tuple(cfg["feature_sizes"]),
                      **{k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k])
                         for k in keys})


def tile_config(cfg: dict):
    from hcunet_tpu_torch.config import TileConfig

    t = cfg["tiles"]
    return TileConfig(eval_size=tuple(t["eval_size"]), pad=tuple(t["pad"]), batch=int(t["batch"]))


def build_model(run):
    """The program's U-Net on the run's device with the benchmark's weights."""
    from hcunet_tpu_torch.models.unet import UNet

    model = UNet(unet_config(run.config)).to(run.device)
    state = model.state_dict()
    state.update(run.weights)
    model.load_state_dict(state)
    return model.eval()


def counters(state) -> dict:
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID

    return {"k1": CONV3D_VALID.launches}


def setup(run):
    from hcunet_tpu_torch.infer.compile import compile_serving_apply

    model = build_model(run)
    apply_fn = compile_serving_apply(model, dtype=run.dtype, device=run.device)
    volumes = {r.index: make_volume(r.shape, r.seed, run.device) for r in run.requests}
    state = {"apply": apply_fn, "ucfg": model.config, "tiles": tile_config(run.config),
             "volumes": volumes, "device": run.device}
    del model
    for item in run.requests[: int(run.mix.get("warmup", 1))]:
        request(state, item)
    return state


def request(state, item):
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask

    vol = state["volumes"][item.index]
    out = predict_segmentation_mask(state["apply"], vol[None], state["ucfg"], state["tiles"],
                                    use_probability_map=True, device=state["device"])
    state["checksum"] = float(out.sum())
    return out


def release(state) -> None:
    state.pop("apply", None)


def k1_launches(run, item):
    """15 launches a batch of tiles, over the tile batches of the request."""
    t = run.config["tiles"]
    core = [min(e, s) for e, s in zip(t["eval_size"], item.shape)]
    halo = [min(p, s) for p, s in zip(t["pad"], item.shape)]
    n = 1
    for s, e in zip(item.shape, core):
        n *= -(-s // e)
    batches = -(-n // int(t["batch"]))
    tile = [e + 2 * h for e, h in zip(core, halo)]
    return flops.unet_k1_launches(run.config, tile, int(t["batch"])) * batches


def map_numbers(pairs) -> dict:
    """Over every voxel of the sampled requests' maps against the
    reference's: the widest and the root-mean-square gap of the
    probabilities; the share of voxels on the other side of 0.5; and, where
    the reference's probability lies in [0.02, 0.98] (where its logit is
    well defined in float32), the root-mean-square gap of the logits over
    the root-mean-square of the reference's logits."""
    worst, sq, n, flips, lsq, lref = 0.0, 0.0, 0, 0, 0.0, 0.0
    for got, want in pairs:
        got, want = got.double(), want.double()
        d = (got - want).abs()
        worst = max(worst, float(d.max()))
        sq += float((d ** 2).sum())
        n += d.numel()
        flips += int(((got > 0.5) != (want > 0.5)).sum())
        keep = (want >= 0.02) & (want <= 0.98)
        g, w = got[keep].clamp(1e-12, 1 - 1e-12), want[keep]
        lw = torch.log(w / (1 - w))
        lsq += float(((torch.log(g / (1 - g)) - lw) ** 2).sum())
        lref += float((lw ** 2).sum())
    return {"map_max_abs": worst, "map_rms": (sq / max(n, 1)) ** 0.5,
            "mask_flip_share": flips / max(n, 1),
            "logit_rel_rms": (lsq / max(lref, 1e-30)) ** 0.5}


def reference_maps(run, sampled, precision: str):
    P = Precision(precision, run.device)
    return [run.reference.tiled_map(run.weights, run.config, vol, P) for vol in sampled]


def check(run, state) -> dict:
    pairs = []
    for item, out in run.sampled():
        want = reference_maps(run, [state["volumes"][item.index]], "float32")[0]
        pairs.append((out[0, ..., 0], want))
    return map_numbers(pairs)


def control(run, precision: str) -> dict:
    """The numbers of the reference in ``precision`` put in the program's
    place, on the first ``sample`` requests of the pool."""
    vols = [make_volume(r.shape, r.seed, run.device) for r in run.requests[: run.sample_size]]
    return map_numbers(zip(reference_maps(run, vols, precision),
                           reference_maps(run, vols, "float32")))
