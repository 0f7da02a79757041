"""Post-norm encoder layer of the PyTorch port vs the JAX package.

The port's plain layer is held against the flax `TorchEncoderLayer` and the
Pallas `encoder_layer_pallas(mxu_bf16=False)` (interpret mode) at atol 2e-5
in float32; the activation parameter against flax for gelu_tanh and relu.
The `mxu_bf16` mode (bf16 operands, float32 sums) is held against the Pallas
kernel's `mxu_bf16=True` at atol 8e-3 per layer (measured 1.2e-3..3.7e-3;
the float32 layer is 0.9e-2..1.4e-2 away, so the bar tells the modes apart)
and over a 2-layer stack against `fused_trunk_apply` at atol 1e-2 (measured
6.9e-3; the float32 stack is 1.6e-2 away).
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
from diffusestylegesture_tpu.ops.encoder_layer_pallas import encoder_layer_pallas, fused_trunk_apply
from diffusestylegesture_torch.models.convert import encoder_layer_state_dict_from_flax
from diffusestylegesture_torch.models.transformer import TorchEncoderLayer, TorchTransformerEncoder
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


def _pallas_bf16(x, params):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(encoder_layer_pallas(jnp.asarray(x), params, H, mxu_bf16=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_mxu_bf16_matches_pallas_bf16(seed):
    _, params, layer, x = _layers("gelu", seed=seed)
    with torch.no_grad():
        out = np32(layer(torch.from_numpy(x), mxu_bf16=True))
        f32 = np32(layer(torch.from_numpy(x)))
    pal = _pallas_bf16(x, params["params"])
    np.testing.assert_allclose(out, pal, atol=8e-3)
    assert np.abs(f32 - pal).max() > np.abs(out - pal).max()


def test_plain_mxu_bf16_stack_matches_fused_trunk():
    trunk = TorchTransformerEncoder(2, D, H, F, "gelu").eval()
    enc = {}
    for i in range(2):
        _, params, layer, x = _layers("gelu", seed=10 + i)
        enc[f"layers_{i}"] = params["params"]
        trunk.layers[i].load_state_dict(layer.state_dict())
    with torch.no_grad():
        out = np32(trunk(torch.from_numpy(x), impl="plain", mxu_bf16=True))
        f32 = np32(trunk(torch.from_numpy(x), impl="plain"))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_trunk_apply(jnp.asarray(x), enc, H, mxu_bf16=True))
    np.testing.assert_allclose(out, ref, atol=1e-2)
    assert np.abs(f32 - ref).max() > np.abs(out - ref).max()


def test_cpu_wrapper_passes_mxu_bf16_and_counts_no_launch():
    _, _, layer, x = _layers("gelu", seed=3)
    before = (ops_encoder_layer.launches, ops_encoder_layer.launches_bf16)
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(torch.from_numpy(x), layer, mxu_bf16=True)
        assert torch.equal(out, layer(torch.from_numpy(x), mxu_bf16=True))
        assert not torch.equal(out, layer(torch.from_numpy(x)))
    assert (ops_encoder_layer.launches, ops_encoder_layer.launches_bf16) == before


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    _, _, layer, x = _layers("gelu", seed=2)
    before = ops_encoder_layer.launches
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(torch.from_numpy(x), layer)
        assert torch.equal(out, layer(torch.from_numpy(x)))
    assert ops_encoder_layer.launches == before
