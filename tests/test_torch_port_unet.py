"""The port's UNet forward and BN-folded serving forward against the JAX
package's on the production config, and the weights carried across by
``utils/port_jax.py``.

Weights get random conv biases, batch-norm affine parameters and running
statistics (``tests/torch_port_support.py``).  atol 5e-5: float32 through 15
convs whose sums XLA and PyTorch order differently — the tolerance of the
JAX package's own serving parity tests.
"""

import numpy as np
import pytest
import torch

from hcunet_tpu.utils.port_torch import (
    unet_state_dict_from_variables,
    unet_variables_from_torch_state_dict,
)
from hcunet_tpu_torch.config import UNetConfig
from hcunet_tpu_torch.models.unet import UNet
from hcunet_tpu_torch.utils.port_jax import (
    jax_variables_from_unet_state_dict,
    unet_state_dict_from_jax_variables,
)
from tests.torch_port_support import SMALL, assert_forwards_match, jax_unet


@pytest.fixture(scope="module")
def production():
    return jax_unet({}, (156, 156, 10))


def test_port_forward_and_serving_match_jax_production_3d(production):
    assert_forwards_match(production, (156, 156, 10), 1)


def _assert_tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("name", ["production_3d", "small"])
def test_weights_round_trip_with_jax_porters(production, name):
    cfg, _, variables = production if name == "production_3d" else jax_unet(SMALL, (48, 48, 8))
    sd = unet_state_dict_from_jax_variables(variables, cfg)
    # the port's names are the reference state dict's: the port model loads
    # it strictly, and the JAX package's own porter reads it back
    model = UNet(cfg)
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
    _assert_tree_equal(
        unet_variables_from_torch_state_dict(model.state_dict(), cfg), variables
    )
    _assert_tree_equal(jax_variables_from_unet_state_dict(model.state_dict(), cfg), variables)
    # and the JAX package's writer produces a state dict the port loads
    model.load_state_dict(unet_state_dict_from_variables(variables, cfg))
    _assert_tree_equal(jax_variables_from_unet_state_dict(model.state_dict(), cfg), variables)


def test_port_unet_rejects_bad_inputs():
    model = UNet(UNetConfig.production_3d())
    with pytest.raises(ValueError, match="channels"):
        model(torch.zeros((1, 156, 156, 10, 3)))
    with pytest.raises(ValueError, match="too small|empty output"):
        model(torch.zeros((1, 40, 40, 10, 4)))
