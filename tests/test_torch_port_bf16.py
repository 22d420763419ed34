"""The port's two models in bfloat16 against their JAX twins in bfloat16, on
the CPU, on the same weights and the same numpy input.

Production runs both models in bf16, so parity in float32 alone is not
enough.  Tolerances: both sides round every layer's float32 sum to bf16
(8 significant bits), and a value near a rounding boundary can land on either
side; over the layers these differences add up.  Each tolerance is about
twice the largest difference measured here on these seeds.  A loose
tolerance could hide a real mismatch, so each test also holds the two sides'
own bf16-versus-float32 gaps to the same order (within 4x of each other):
a port that rounded somewhere the JAX package does not, or computed in
float32 where it should round, would move its gap away from JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.config import DetectorConfig as JaxDetectorConfig
from hcunet_tpu.infer.compile import compile_serving_apply as jax_serving_apply
from hcunet_tpu.models.detection import LEVELS
from hcunet_tpu.models.detection import Detector as JaxDetector
from hcunet_tpu_torch.config import DetectorConfig
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.models.detection import Detector
from hcunet_tpu_torch.utils.port_jax import detector_state_dict_from_jax_variables
from tests.test_torch_port_detection import CFG, HW, randomize
from tests.torch_port_support import SMALL, jax_unet, port_unet

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _check(name, jax_out, port_out, rel_tol):
    """``jax_out`` and ``port_out``: ``{"f32": array, "bf16": array}``.  The
    bf16 outputs agree within ``rel_tol`` x max(1, max|JAX f32|), and each
    side's bf16-versus-float32 gap is of the other's order."""
    scale = max(1.0, float(np.abs(jax_out["f32"]).max()))
    diff = float(np.abs(port_out["bf16"] - jax_out["bf16"]).max())
    gap_jax = float(np.abs(jax_out["bf16"] - jax_out["f32"]).max())
    gap_port = float(np.abs(port_out["bf16"] - port_out["f32"]).max())
    assert diff <= rel_tol * scale, (name, diff, rel_tol * scale)
    # both really ran in bf16 (a bf16 result differs from float32's) ...
    assert gap_jax > 1e-4 * scale and gap_port > 1e-4 * scale, (name, gap_jax, gap_port)
    # ... and rounded about as much
    assert 0.25 <= gap_port / gap_jax <= 4.0, (name, gap_port, gap_jax)


def test_serving_forward_bf16_matches_jax():
    """``compile_serving_apply(dtype=bfloat16)`` on the two-level net, against
    the JAX ``compile_serving_apply(dtype=jnp.bfloat16)``.  Measured here:
    port vs JAX 0.033 on logits of max 1.78 (1.9 % of the scale), each side's
    own bf16 gap 0.031-0.040; the tolerance is 4 % of the scale."""
    spatial = (40, 40, 8)
    cfg, jmodel, variables = jax_unet(SMALL, spatial)
    x = np.random.default_rng(1).random((2, *spatial, cfg.in_channels), np.float32)
    model = port_unet(cfg, variables)
    jax_out, port_out = {}, {}
    for name, (jdt, tdt) in DTYPES.items():
        jax_out[name] = np.asarray(
            jax_serving_apply(jmodel, variables, dtype=jdt)(jnp.asarray(x)), np.float32
        )
        got = compile_serving_apply(model, dtype=tdt, device="cpu")(torch.from_numpy(x))
        port_out[name] = got.float().numpy()
        assert port_out[name].shape == jax_out[name].shape == (2, 26, 26, 6, 1)
    # float32 first: the same function, so a bf16 difference is rounding
    np.testing.assert_allclose(port_out["f32"], jax_out["f32"], atol=5e-5, rtol=0)
    _check("serving forward", jax_out, port_out, 4e-2)


@pytest.fixture(scope="module")
def detector_outputs():
    """The ResNet50-FPN trunk at ``backbone_width=8`` on one image, in float32
    and bf16, on both sides: ``{output: (JAX {dtype: array}, port {dtype:
    array})}`` for each pyramid level and each RPN head output, channels
    last."""
    backbone = "resnet50"
    jdet = JaxDetector(JaxDetectorConfig(**CFG), backbone=backbone, backbone_width=8)
    shapes = jax.eval_shape(lambda k: jdet.init(k, HW[backbone]), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = {
        part: {kind: randomize(tree, rng) for kind, tree in shapes[part].items()}
        for part in ("trunk", "head")
    }
    state = detector_state_dict_from_jax_variables(variables, backbone)
    img = np.random.default_rng(1).random((1, *HW[backbone], 3), np.float32)
    out = {}
    for name, (jdt, tdt) in DTYPES.items():
        jdet = JaxDetector(JaxDetectorConfig(**CFG), backbone=backbone, backbone_width=8, dtype=jdt)
        tdet = Detector(DetectorConfig(**CFG), backbone=backbone, backbone_width=8,
                        dtype=tdt, device="cpu")
        tdet.load_state_dict(state)
        assert next(tdet.parameters()).dtype == tdt
        # jitted, as the JAX package runs it (op by op takes 4x longer here)
        trunk = jax.jit(lambda v, x, m=jdet.trunk: m.apply(v, x, train=False))
        jpyr, jrpn = trunk(variables["trunk"], jnp.asarray(img))
        with torch.no_grad():
            pyr, rpn = tdet(torch.from_numpy(img).permute(0, 3, 1, 2).to(tdt))
        for lvl in LEVELS:
            pairs = [(lvl, jpyr[lvl], pyr[lvl])]
            pairs += [(f"{lvl}.rpn{i}", jrpn[lvl][i], rpn[lvl][i]) for i in range(2)]
            for key, j, t in pairs:
                jo, to = out.setdefault(key, ({}, {}))
                jo[name] = np.asarray(j, np.float32)
                to[name] = t.permute(0, 2, 3, 1).float().numpy()
    return out


def test_detector_trunk_bf16_matches_jax(detector_outputs):
    """``Detector(dtype=bfloat16)`` against the JAX ``Detector(dtype=
    jnp.bfloat16)``: every FPN level and both RPN outputs per level.
    Measured here: port vs JAX at most 1.3 % of the scale (p2), each side's
    own bf16 gap 1.2-1.3 % there, the two gaps within 2x of each other at
    every output; the tolerance is 3 % of the scale."""
    assert len(detector_outputs) == 3 * len(LEVELS)
    for key, (jax_out, port_out) in detector_outputs.items():
        assert port_out["bf16"].shape == jax_out["bf16"].shape
        scale = max(1.0, float(np.abs(jax_out["f32"]).max()))
        np.testing.assert_allclose(port_out["f32"], jax_out["f32"], atol=2e-4 * scale, rtol=0)
        _check(f"detector {key}", jax_out, port_out, 3e-2)
