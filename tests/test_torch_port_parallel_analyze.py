"""``analyze(mesh=)`` of the PyTorch port against its single-device
``analyze`` and against the JAX package's ``analyze(mesh=)``, on the 8-way
``spatial`` meshes of ``tests/torch_port_support.py``.

The scene and the models are ``test_torch_port_pipeline.py``'s (the bench's
blob scene at 96 x 96 x 6, the two-level U-Net with its output conv scaled
so that its map follows the blobs, the small-backbone detector), with tiles
of eval X 16: each 48-wide chunk is bucket-padded to the shard quantum 8 ×
16 = 128, so every chunk rides the mesh.  Tolerances: against the port's
single-device run, the mask within 1e-6 and ``cells.csv`` byte for byte;
against JAX, the pipeline tests' 1e-4 on the mask and the same cells.
"""

import os

import numpy as np
import pytest
import torch

from hcunet_tpu.config import PipelineConfig as JaxPipelineConfig
from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.config import UNetConfig as JaxUNetConfig
from hcunet_tpu.config import WatershedConfig as JaxWatershedConfig
from hcunet_tpu.infer import pipeline as jpipeline
from hcunet_tpu_torch import PipelineConfig, TileConfig, WatershedConfig, analyze
from tests.test_torch_port_pipeline import _volume, models  # noqa: F401
from tests.torch_port_support import SMALL, spatial8  # noqa: F401

TILES = dict(eval_size=(16, 24, 6), pad=(16, 16, 2), batch=2)


def _key(cells):
    return [(c.unique_id, tuple(np.round(c.center, 6)), c.volume) for c in cells]


@pytest.mark.parametrize("detection", [False, True])
def test_port_analyze_mesh_matches_single_device(models, spatial8, tmp_path, detection):  # noqa: F811
    port_mesh, jax_mesh = spatial8
    vol = _volume("float32")
    cfg = PipelineConfig(numchunks=3, unet=models["cfg"], tiles=TileConfig(**TILES),
                         watershed=WatershedConfig(expand_mask=2))
    common = dict(volume=vol, unet_apply=models["port_apply"], cfg=cfg, fit_cochlea=False,
                  detector=models["tdet"] if detection else None)
    single = analyze(work_dir=str(tmp_path / "single"), device="cpu", **common)
    sharded = analyze(work_dir=str(tmp_path / "mesh"), mesh=port_mesh, **common)
    assert single.mesh_chunks is None
    assert sharded.mesh_chunks == {"sharded": 4, "fallback": 0}
    np.testing.assert_allclose(sharded.mask, single.mask, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(sharded.unique_mask, single.unique_mask)
    with open(tmp_path / "single" / "cells.csv", "rb") as f:
        want_csv = f.read()
    with open(tmp_path / "mesh" / "cells.csv", "rb") as f:
        assert f.read() == want_csv
    if detection:
        assert len(single.cells) > 0

    jcfg = JaxPipelineConfig(numchunks=3, unet=JaxUNetConfig(**SMALL),
                             tiles=JaxTileConfig(**TILES),
                             watershed=JaxWatershedConfig(expand_mask=2))
    jres = jpipeline.analyze(
        volume=vol, unet_apply=models["jax_apply"], cfg=jcfg, fit_cochlea=False,
        detector=models["jdet"] if detection else None,
        detector_variables=models["det_vars"] if detection else None,
        work_dir=os.path.join(tmp_path, "jax"), overlap=False, mesh=jax_mesh,
    )
    assert jres.mesh_chunks == sharded.mesh_chunks
    np.testing.assert_allclose(sharded.mask, jres.mask, atol=1e-4, rtol=0)
    assert _key(sharded.cells) == _key(jres.cells)
