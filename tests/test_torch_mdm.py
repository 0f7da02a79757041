"""ZEGGS MDM denoiser of the PyTorch port vs the flax MDM.

Parameters cross from flax to the port through
`models/convert.py::mdm_state_dict_from_flax`; cond and uncond forwards
agree at atol 5e-4 (the converted-weight bar of `MIGRATION.md`; float32
differences of a few 1e-6 are expected). The bridge closes: port
state_dict → JAX `convert_mdm_zeggs` → flax params → `mdm_state_dict_from_flax`
gives back the same tensors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu.models import convert as jax_convert
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_torch.models.convert import mdm_state_dict_from_flax
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig

from torch_port_utils import np32, randomize_flax_params

B, NJ, T = 2, 32, 22
KW = dict(njoints=NJ, latent_dim=128, ff_size=96, num_layers=2, window_size=11, n_seed=8)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    t = np.array([999, 3], np.int64)
    cond = {
        "style": rng.standard_normal((B, 6)).astype(np.float32),
        "seed": rng.standard_normal((B, NJ, 1, 8)).astype(np.float32),
        "audio": rng.standard_normal((B, T, 1024)).astype(np.float32),
        "mask_local": np.ones((B, T), bool),
    }
    return x, t, cond


def _models():
    fmodel = FlaxMDM(FlaxMDMConfig(**KW))
    x, t, cond = _inputs()
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                         {k: jnp.asarray(v) for k, v in cond.items()})
    params = {"params": randomize_flax_params(params["params"], 0)}
    model = MDM(MDMConfig(**KW)).eval()
    model.load_state_dict(mdm_state_dict_from_flax(params))
    return fmodel, params, model


@pytest.mark.parametrize("uncond", [None, [False, True]], ids=["cond", "cfg_mixed"])
def test_forward_matches_flax(uncond):
    fmodel, params, model = _models()
    x, t, cond = _inputs(1)
    ju = None if uncond is None else jnp.asarray(uncond)
    ref = fmodel.apply(params, jnp.asarray(x), jnp.asarray(t),
                       {k: jnp.asarray(v) for k, v in cond.items()}, uncond=ju)
    tu = None if uncond is None else torch.tensor(uncond)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    {k: torch.from_numpy(v) for k, v in cond.items()}, uncond=tu)
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=5e-4)


def test_weight_bridge_round_trip():
    _, _, model = _models()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = mdm_state_dict_from_flax(jax_convert.convert_mdm_zeggs(sd, num_layers=KW["num_layers"]))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_unsupported_modes_raise():
    """The parallel slice's fields build: split q/k/v (holding the packed
    model's weights for a seed) and remat; a pipelined trunk or a
    sequence-parallel local attention without its mesh, an unknown trunk and
    MoE with a recomputed trunk raise (the parallel paths themselves:
    `test_torch_parallel_*.py`)."""
    for bad in (dict(trunk_impl="pipeline"), dict(seq_parallel=True),
                dict(trunk_impl="ring"), dict(moe_experts=2, remat=True)):
        with pytest.raises(ValueError):
            MDM(MDMConfig(**{**KW, **bad}))
    for ok in (dict(cond_mode="cross_local_attention5_style1"),
               dict(cond_mode="style1", arch="trans_dec"), dict(moe_experts=2),
               dict(split_qkv=True), dict(remat=True)):
        MDM(MDMConfig(**{**KW, **ok}))