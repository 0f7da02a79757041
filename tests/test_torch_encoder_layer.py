"""Post-norm encoder layer of the PyTorch port vs the JAX package.

The port's plain layer is held against the flax `TorchEncoderLayer` and the
Pallas `encoder_layer_pallas(mxu_bf16=False)` (interpret mode) at atol 2e-5
in float32; the activation parameter against flax for gelu_tanh and relu.
The CUDA kernel is held against the plain layer on a card in
`test_torch_isolation.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusestylegesture_tpu.models.transformer import TorchEncoderLayer as FlaxEncoderLayer
from diffusestylegesture_tpu.ops.encoder_layer_pallas import encoder_layer_pallas
from diffusestylegesture_torch.models.convert import encoder_layer_state_dict_from_flax
from diffusestylegesture_torch.models.transformer import TorchEncoderLayer
from diffusestylegesture_torch.ops import encoder_layer as ops_encoder_layer

from torch_port_utils import np32, randomize_flax_params

B, T, D, H, F = 2, 89, 128, 4, 256  # T = 88 frames + 1 token, as on the main path


def _layers(activation, seed=0):
    flax_layer = FlaxEncoderLayer(D, H, F, dropout=0.0, activation=activation)
    x = np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)
    params = flax_layer.init(jax.random.PRNGKey(seed), jnp.asarray(x), True)
    params = {"params": randomize_flax_params(params["params"], seed)}
    layer = TorchEncoderLayer(D, H, F, activation).eval()
    layer.load_state_dict(encoder_layer_state_dict_from_flax(params["params"]))
    return flax_layer, params, layer, x


def test_plain_matches_flax_and_pallas():
    flax_layer, params, layer, x = _layers("gelu")
    with torch.no_grad():
        out = np32(layer(torch.from_numpy(x)))
    ref = np.asarray(flax_layer.apply(params, jnp.asarray(x), True))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(encoder_layer_pallas(jnp.asarray(x), params["params"], H, mxu_bf16=False))
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out, pal, atol=2e-5)


@pytest.mark.parametrize("activation", ["gelu_tanh", "relu"])
def test_activation_parameter_matches_flax(activation):
    flax_layer, params, layer, x = _layers(activation, seed=1)
    with torch.no_grad():
        out = np32(layer(torch.from_numpy(x)))
    np.testing.assert_allclose(out, np.asarray(flax_layer.apply(params, jnp.asarray(x), True)),
                               atol=2e-5)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    _, _, layer, x = _layers("gelu", seed=2)
    before = ops_encoder_layer.launches
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(torch.from_numpy(x), layer)
        assert torch.equal(out, layer(torch.from_numpy(x)))
    assert ops_encoder_layer.launches == before
