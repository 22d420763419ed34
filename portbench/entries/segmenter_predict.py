"""Entry ``segmenter_predict``: a library user's ``Segmenter.predict`` on
stacks of mixed sizes, numpy in and numpy out.

The program: ``infer/serving.py::Segmenter`` over the configuration's
U-Net with the benchmark's weights, in the mix's dtype, packed (the
BN-folded serving forward), with the configuration's tile geometry (what
``auto_tile_config`` picks for an 80 GB card).
Each request hands it a normalized host volume ``[X, Y, Z, 4]`` (float32)
and returns with the map on the host.  The pool's volumes are made on the
card and brought to the host before the window; one request of each
distinct depth (which sets the tile shape) warms the program up.  The
check compares every voxel of each sampled request's map with the
reference's, bucketing and all.
"""

from __future__ import annotations

import torch

from portbench.entries import tiled_chunk
from portbench.inputs import make_volume
from portbench.reference.precision import Precision

counters = tiled_chunk.counters
map_numbers = tiled_chunk.map_numbers


def setup(run):
    from hcunet_tpu_torch.infer.serving import Segmenter

    model = tiled_chunk.build_model(run)
    seg = Segmenter(model, tile_cfg=tiled_chunk.tile_config(run.config), dtype=run.dtype,
                    packed=True, device=run.device)
    del model
    volumes = {r.index: make_volume(r.shape, r.seed, run.device).cpu().numpy()
               for r in run.requests}
    state = {"seg": seg, "volumes": volumes}
    depths = set()
    for item in run.requests:
        if item.shape[2] not in depths:
            depths.add(item.shape[2])
            request(state, item)
    return state


def request(state, item):
    return state["seg"].predict(state["volumes"][item.index])


def release(state) -> None:
    state.pop("seg", None)


def k1_launches(run, item):
    """The tile batches of the request's bucket."""
    bucket = run.reference.bucket_shape(run.config, item.shape)
    return tiled_chunk.k1_launches(run, type(item)(item.index, tuple(bucket), item.seed))


def reference_maps(run, volumes, precision: str):
    P = Precision(precision, run.device)
    return [run.reference.bucketed_map(run.weights, run.config,
                                       torch.from_numpy(v).to(run.device), P)
            for v in volumes]


def check(run, state) -> dict:
    pairs = []
    for item, out in run.sampled():
        want = reference_maps(run, [state["volumes"][item.index]], "float32")[0]
        pairs.append((torch.from_numpy(out).to(run.device), want))
    return map_numbers(pairs)


def control(run, precision: str) -> dict:
    """The numbers of the reference in ``precision`` put in the program's
    place, on the first ``sample`` requests of the pool."""
    vols = [make_volume(r.shape, r.seed, run.device).cpu().numpy()
            for r in run.requests[: run.sample_size]]
    return map_numbers(zip(reference_maps(run, vols, precision),
                           reference_maps(run, vols, "float32")))
