"""Every branch of the ZEGGS MDM's forward in the PyTorch port vs the flax MDM.

The three cross-local orderings (`cross_local_attention3` / `5` / plain
`cross_local_attention`), the plain branches `style1` / `style2` × `trans_enc`
/ `mytrans_enc` / `trans_dec` / `gru`, `audio_feat` wavlm / mfcc / 'wav
encoder', `n_seed = 0` and MoE trunks. Both sides get the same seeded numpy
weights (flax params → `models/convert.py::mdm_state_dict_from_flax`) and
inputs. Inference agrees at atol 5e-4 (the converted-denoiser bar, as
`test_torch_mdm.py`); the train forward, with the JAX model's condition
drops recorded from its own `mask_cond` calls and replayed through
`cond_drop` (dropout 0), at 1e-5, a MoE model's load-balance loss too;
parameter gradients of one plain-branch and one cross-local variant at rtol
1e-4.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu.models import mdm as jax_mdm
from diffusestylegesture_tpu.models.moe import make_moe_apply
from diffusestylegesture_torch.models.convert import mdm_state_dict_from_flax
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig

from torch_port_utils import np32, randomize_flax_params

B, NJ, T, STYLE_DIM, N_SEED = 2, 24, 22, 16, 8
BASE = dict(njoints=NJ, latent_dim=64, ff_size=48, num_layers=2, window_size=11,
            n_seed=N_SEED, style_dim=STYLE_DIM, local_heads=8, num_heads=4,
            cond_mode="cross_local_attention3_style1")
AUDIO_IN = {"wavlm": 40, "mfcc": 13, "wav encoder": 32}
VARIANTS = {
    "cla3_wavlm": dict(cond_mode="cross_local_attention3_style1"),
    "cla5_wavlm": dict(cond_mode="cross_local_attention5_style1"),
    "cla_wavlm": dict(cond_mode="cross_local_attention_style1"),
    "cla3_mfcc": dict(audio_feat="mfcc"),
    "cla3_wav_encoder": dict(audio_feat="wav encoder"),
    "cla3_no_seed": dict(n_seed=0, style_dim=64),
    "cla3_style2_no_seed": dict(cond_mode="cross_local_attention3_style2", n_seed=0),
    "style1_trans_enc": dict(cond_mode="style1", arch="trans_enc"),
    "style1_mytrans_enc": dict(cond_mode="style1", arch="mytrans_enc", audio_feat="mfcc"),
    "style1_trans_dec": dict(cond_mode="style1", arch="trans_dec"),
    "style1_gru": dict(cond_mode="style1", arch="gru", audio_feat="mfcc"),
    "style2_trans_enc": dict(cond_mode="style2", arch="trans_enc", audio_feat="mfcc"),
    "style2_mytrans_enc": dict(cond_mode="style2", arch="mytrans_enc"),
    "style2_trans_dec": dict(cond_mode="style2", arch="trans_dec", audio_feat="wav encoder"),
    "style2_gru": dict(cond_mode="style2", arch="gru"),
    "cla3_moe": dict(moe_experts=4),
    "style2_trans_enc_moe": dict(cond_mode="style2", arch="trans_enc", moe_experts=3,
                                 audio_feat="mfcc"),
}


def _kw(name):
    return dict(BASE, **VARIANTS[name])


def _inputs(name, seed=1):
    kw = _kw(name)
    rng = np.random.default_rng(seed)
    feat = kw.get("audio_feat", "wavlm")
    cond = {"style": rng.standard_normal((B, 6)).astype(np.float32),
            "audio": rng.standard_normal((B, T, AUDIO_IN[feat])).astype(np.float32),
            "mask_local": np.ones((B, T), bool)}
    if kw["n_seed"]:
        cond["seed"] = rng.standard_normal((B, NJ, 1, kw["n_seed"])).astype(np.float32)
    x = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    return x, np.array([999, 3], np.int64), cond


def _jax(cond):
    return {k: jnp.asarray(v) for k, v in cond.items()}


def _torch(cond):
    return {k: torch.from_numpy(v) for k, v in cond.items()}


@functools.lru_cache(maxsize=None)
def _models(name):
    kw = _kw(name)
    fmodel = jax_mdm.MDM(jax_mdm.MDMConfig(**kw, dropout=0.0))
    x, t, cond = _inputs(name, 0)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), _jax(cond))
    params = {"params": randomize_flax_params(params["params"], 0)}
    feat = kw.get("audio_feat", "wavlm")
    model = MDM(MDMConfig(**kw, dropout=0.0, audio_in_dim=AUDIO_IN["wavlm"], impl="plain"))
    model.load_state_dict(mdm_state_dict_from_flax(params))
    assert feat != "wavlm" or model.WavEncoder.audio_feature_map.in_features == AUDIO_IN[feat]
    return fmodel, params, model.eval()


@pytest.mark.parametrize("uncond", [None, [False, True]], ids=["cond", "cfg_mixed"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_flax(name, uncond):
    fmodel, params, model = _models(name)
    x, t, cond = _inputs(name)
    ju = None if uncond is None else jnp.asarray(uncond)
    ref = fmodel.apply(params, jnp.asarray(x), jnp.asarray(t), _jax(cond), uncond=ju)
    tu = None if uncond is None else torch.tensor(uncond)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), _torch(cond), uncond=tu)
    assert out.shape == (B, NJ, 1, T)
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=5e-4)


def _recorded_drops(monkeypatch):
    """The JAX model's condition drops, (last dim of what was masked, drops),
    recorded from its own `mask_cond` calls."""
    calls = []
    real = jax_mdm.mask_cond

    def recording(c, *, cond_mask_prob, train, uncond=None, rng=None):
        if train and cond_mask_prob > 0.0:
            calls.append((c.shape[-1], np.array(
                jax.random.bernoulli(rng, cond_mask_prob, (c.shape[0], 1)))[:, 0]))
        return real(c, cond_mask_prob=cond_mask_prob, train=train, uncond=uncond, rng=rng)

    monkeypatch.setattr(jax_mdm, "mask_cond", recording)
    return calls


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_forward_with_replayed_drops_matches_flax(name, monkeypatch):
    """cond_mask_prob 0.5 so that both kinds of draw occur; each recorded
    drop goes to the port's style slot (the style1 or the style2 embedding,
    `style_dim` wide) or its seed slot."""
    fmodel, params, model = _models(name)
    kw = _kw(name)
    x, t, cond = _inputs(name, 2)
    calls = _recorded_drops(monkeypatch)
    fmodel = jax_mdm.MDM(jax_mdm.MDMConfig(**kw, dropout=0.0, cond_mask_prob=0.5))
    apply = make_moe_apply(fmodel) if kw.get("moe_experts") else fmodel.apply
    ref = apply(params, jnp.asarray(x), jnp.asarray(t), _jax(cond), train=True,
                rngs={"cond_mask": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(8)})
    no = np.zeros(B, bool)
    style_drop = next((d for w, d in calls if w == kw["style_dim"]), no)
    seed_drop = next((d for w, d in calls if w != kw["style_dim"]), no)
    assert len(calls) == ("style1" in kw["cond_mode"] or (
        "style2" in kw["cond_mode"] and kw.get("arch") != "gru"
        and "cross_local" not in kw["cond_mode"])) + bool(kw["n_seed"])
    tmodel = MDM(MDMConfig(**kw, dropout=0.0, cond_mask_prob=0.5,
                           audio_in_dim=AUDIO_IN["wavlm"], impl="plain"))
    tmodel.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(t), _torch(cond), train=True,
                     cond_drop=(torch.from_numpy(style_drop), torch.from_numpy(seed_drop)))
    if kw.get("moe_experts"):
        (out, aux), (ref, jaux) = out, ref
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np32(out), np.asarray(ref), atol=1e-5 * max(
        1.0, float(np.abs(np.asarray(ref)).max())))


@pytest.mark.parametrize("name", ["style2_trans_dec", "cla_wavlm"])
def test_gradients_match_flax(name):
    fmodel, params, model = _models(name)
    x, t, cond = _inputs(name, 3)
    w = np.random.default_rng(4).standard_normal((B, NJ, 1, T)).astype(np.float32)

    def jloss(p):
        return jnp.sum(fmodel.apply(p, jnp.asarray(x), jnp.asarray(t), _jax(cond)) * w)

    jgrads = jax.jit(jax.grad(jloss))(params)
    model.zero_grad()
    loss = (model(torch.from_numpy(x), torch.from_numpy(t), _torch(cond))
            * torch.from_numpy(w)).sum()
    loss.backward()
    ref = mdm_state_dict_from_flax(jgrads)
    # a parameter the branch does not use (input_process on the plain path) has
    # no gradient in torch and a zero one in JAX
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert set(grads) == set(ref)
    for k, g in ref.items():
        g = g.numpy()
        np.testing.assert_allclose(np32(grads[k]), g, rtol=1e-4, atol=1e-6 * np.abs(g).max(),
                                   err_msg=k)


def test_validate_raises_only_for_the_parallel_slice():
    """The parallel fields validate (their meshes given); without the mesh
    they raise, and the JAX refusals stay: no encoder trunk (gru,
    trans_dec) for split q/k/v, MoE or a pipelined trunk."""
    for bad in (dict(trunk_impl="pipeline"), dict(seq_parallel=True)):
        with pytest.raises(ValueError, match="mesh"):
            MDMConfig(**dict(BASE, **bad)).validate()
    for ok in (dict(split_qkv=True), dict(trunk_impl="pipeline", pipe_mesh=object()),
               dict(seq_parallel=True, seq_mesh=object())):
        MDMConfig(**dict(BASE, **ok)).validate()
    for kw in VARIANTS.values():
        MDMConfig(**dict(BASE, **kw)).validate()
    for bad in (dict(cond_mode="style1", arch="gru", moe_experts=2),
                dict(cond_mode="style1", arch="trans_dec", split_qkv=True),
                dict(cond_mode="style1", arch="gru", trunk_impl="pipeline", pipe_mesh=object()),
                dict(cond_mode="style1", arch="lstm"), dict(audio_feat="mel")):
        with pytest.raises(ValueError):
            MDMConfig(**dict(BASE, **bad)).validate()
