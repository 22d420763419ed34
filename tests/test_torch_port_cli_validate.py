"""The port's ``validate`` command against the JAX package's, on the CPU
(``--device cpu``), from the same U-Net checkpoint
(``test_torch_port_cli.py::write_checkpoints``) on a 2-sample ``.npy``
Stack: the printed summaries within the tolerances of
``tests/test_torch_port_validate.py`` (the thresholded masks equal except
where the JAX probability lies within 5e-5 of the threshold; dice and
error rates within 1e-6 of JAX's, or what those voxels can move them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu import cli as jcli
from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.data import transforms as jt
from hcunet_tpu.data.datasets import Stack as JaxStack
from hcunet_tpu.infer.compile import compile_serving_apply as jax_serving_apply
from hcunet_tpu.infer.tiling import predict_segmentation_mask as jax_predict
from hcunet_tpu.utils.checkpoint import load_unet as jax_load_unet
from hcunet_tpu_torch import cli as tcli
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
from hcunet_tpu_torch.utils.checkpoint import load_unet

from test_torch_port_cli import one_thread, run, write_checkpoints  # noqa: F401
from test_torch_port_validate import assert_validation_close, write_npy_stack


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("ckpts"))


def test_validate_matches_jax(tmp_path, capsys, ckpts):
    root = str(tmp_path / "stack")
    write_npy_stack(root, shape=(48, 48, 6))
    want = run(capsys, jcli.main, ["validate", root, "--unet", ckpts["unet"]])
    got = run(capsys, tcli.main, ["validate", root, "--unet", ckpts["unet"], "--device", "cpu"])
    # the masks behind the summaries, on the geometry the command lines use
    ds = JaxStack(root, joint_transforms=[jt.to_float(), jt.reshape()],
                  image_transforms=[jt.normalize()])
    jmodel, jvars, _ = jax_load_unet(ckpts["unet"])
    japply = jax.tree_util.Partial(jax_serving_apply(jmodel, jvars, dtype=jnp.float32))
    tmodel, _, _ = load_unet(ckpts["unet"])
    tapply = compile_serving_apply(tmodel, dtype=torch.float32, device="cpu")
    probs, masks = [], []
    for i in range(len(ds)):
        image = ds[i][0]
        probs.append(np.asarray(jax_predict(japply, jnp.asarray(image), jmodel.config, JaxTileConfig(),
                                            use_probability_map=True))[0, ..., 0])
        masks.append(predict_segmentation_mask(tapply, image, tmodel.config, None, use_probability_map=True,
                                               device="cpu").numpy()[0, ..., 0] > 0.5)
    assert len(got) == 2
    assert_validation_close(got, want, masks, probs, 0.5)
