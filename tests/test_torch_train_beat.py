"""BEAT/TWH training in the PyTorch port against the JAX package.

* `train/state.py::make_beat_cond_builder` for attention3 / 4 / 5: x_start,
  every conditioning entry and the mask exactly the JAX builder's; attention5
  with n_seed = 0 raises in both.
* `data/device_cache.py`: the BEAT/TWH cache holds the JAX cache's padded
  clips, lengths and speakers; its crop for fixed clip indices and starts
  equals JAX's `dynamic_slice`; drawn starts stay below max(len − n_poses, 1)
  and cover that range; a clip shorter than n_poses raises.
* A tiny MDMPlus (`tests/test_torch_mdm_plus.py`'s layout: njoints 36, latent
  128, 2 layers, T 30, 5 seed frames, window 15) per variant, the same
  converted weights in both packages: every parameter's gradient of one loss
  at rtol 1e-4, then three AdamW + EMA steps of `make_train_step` with the
  JAX draws (t, noise, the style drop and, in attention3, the seed drop)
  recomputed from its key and injected into the port's step, as
  `tests/test_torch_train_step.py` does for ZEGGS: loss, grad norm and param
  norm at 1e-5 relative, weights and EMA at 1e-5 (noise-floor entries at the
  update's bound, as there).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.data import h5_loader as JH
from diffusestylegesture_tpu.data.device_cache import DeviceWindowCache as JaxCache
from diffusestylegesture_tpu.diffusion import gaussian as JG
from diffusestylegesture_tpu.models import mdm_plus as jax_mdm_plus
from diffusestylegesture_tpu.train import state as JS
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.data import h5_loader as TH
from diffusestylegesture_torch.data.device_cache import DeviceWindowCache
from diffusestylegesture_torch.diffusion import gaussian as TG
from diffusestylegesture_torch.models.convert import mdm_plus_state_dict_from_flax
from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig
from diffusestylegesture_torch.train import (TrainConfig, TrainState, make_beat_cond_builder,
                                             make_train_step)

from test_torch_train_step import STEP_CFG, STEP_TOL, assert_named_close, noise_floor_entries
from torch_port_utils import np32, randomize_flax_params

B, NJ, T, NSEED, NT, A, S = 8, 36, 30, 5, 20, 40, 4
KW = dict(njoints=NJ, latent_dim=128, ff_size=96, num_layers=2, source_audio_dim=A,
          audio_feat_dim=32, style_dim_in=S, n_seed=NSEED, window_size=15, dropout=0.0)
MODES = ["cross_local_attention3_style1", "cross_local_attention4_style1",
         "cross_local_attention5_style1"]
BETAS = JD.named_beta_schedule("cosine", NT)
JSCHED = JD.Schedule.create(BETAS)
TSCHED = TD.Schedule.create(BETAS, device="cpu")


def make_batch(seed, b=B, t=T):
    rng = np.random.default_rng(seed)
    return {"motion": rng.standard_normal((b, t, NJ)).astype(np.float32),
            "audio": rng.standard_normal((b, t, A)).astype(np.float32),
            "style": np.eye(S, dtype=np.float32)[rng.integers(0, S, b)]}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("mode", MODES)
def test_cond_builders_match_jax(mode):
    batch = make_batch(1)
    jx, jcond, jmask = JS.make_beat_cond_builder(mode, NSEED)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    tx, tcond, tmask = make_beat_cond_builder(mode, NSEED)(torch_batch(batch))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tcond.keys() == jcond.keys()
    for k in jcond:
        assert tuple(tcond[k].shape) == jcond[k].shape, k
        np.testing.assert_array_equal(tcond[k].numpy(), np.asarray(jcond[k]), err_msg=k)
    want = T - NSEED * (int(mode[len("cross_local_attention")]) - 3)
    assert tcond["audio"].shape[1] == want


def test_attention5_needs_seed_frames():
    batch = make_batch(2)
    with pytest.raises(ValueError, match="n_seed"):
        JS.make_beat_cond_builder("cross_local_attention5_style1", 0)(
            {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="n_seed"):
        make_beat_cond_builder("cross_local_attention5_style1", 0)(torch_batch(batch))


# ---- the device cache's clip crops ----------------------------------------------------


def _stores(tmp_path, lens, n_poses):
    """A port and a JAX dataset over the same clips; gesture rows hold their
    frame index in every channel (before normalization by mean 0, std 1)."""
    rng = np.random.default_rng(0)
    clips = [{"speaker_id": np.eye(S, dtype=np.float32)[i % S],
              "gesture": np.repeat(np.arange(n, dtype=np.float32)[:, None], NJ // 3, 1),
              "audio": rng.standard_normal((n, A - 2)).astype(np.float32),
              "text": rng.standard_normal((n, 2)).astype(np.float32)} for i, n in enumerate(lens)]
    TH.build_h5_dataset(str(tmp_path / "s.npz"), clips)
    JH.build_h5_dataset(str(tmp_path / "s.h5"), clips)
    mean, std = np.zeros(NJ // 3, np.float32), np.ones(NJ // 3, np.float32)
    return (TH.SpeechGestureDataset(str(tmp_path / "s.npz"), mean, std, n_poses),
            JH.SpeechGestureDataset(str(tmp_path / "s.h5"), mean, std, n_poses))


def test_beat_twh_cache_matches_jax_and_crops_like_dynamic_slice(tmp_path):
    n_poses = 20
    port_ds, jax_ds = _stores(tmp_path, (47, 20, 33, 21), n_poses)
    cache = DeviceWindowCache.from_beat_twh(port_ds, "cpu")
    jcache = JaxCache.from_beat_twh(jax_ds)
    assert cache.arrays.keys() == jcache.arrays.keys()
    for k, v in jcache.arrays.items():
        np.testing.assert_array_equal(cache.arrays[k].numpy(), np.asarray(v), err_msg=k)
    idx = np.array([0, 3, 2, 0, 1, 2], np.int64)
    start = np.array([26, 0, 12, 0, 0, 5], np.int64)
    crop = jax.vmap(lambda c, s: jax.lax.dynamic_slice_in_dim(c, s, n_poses, 0))
    ref = {"motion": crop(jcache.arrays["motion_clips"][idx], start),
           "audio": crop(jcache.arrays["audio_clips"][idx], start),
           "style": jcache.arrays["style"][idx]}
    out = DeviceWindowCache.crop_clips(cache.arrays, torch.from_numpy(idx),
                                       torch.from_numpy(start), n_poses)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert cache.sample_fn.keywords == {"n_poses": n_poses}


def test_drawn_starts_stay_below_the_exclusive_high(tmp_path):
    n_poses = 20
    lens = (30, 20, 21, 27)
    port_ds, _ = _stores(tmp_path, lens, n_poses)
    cache = DeviceWindowCache.from_beat_twh(port_ds, "cpu")
    gen = torch.Generator().manual_seed(5)
    seen = {i: set() for i in range(len(lens))}
    for _ in range(40):
        batch = cache.sample_fn(cache.arrays, gen, 64)
        motion = batch["motion"][..., 0].numpy()  # frame indices of each crop
        clip = batch["style"].argmax(-1).numpy()  # the speaker one-hot names the clip
        assert batch["motion"].shape == (64, n_poses, NJ)
        assert batch["audio"].shape == (64, n_poses, A) and batch["style"].shape == (64, S)
        np.testing.assert_array_equal(motion, motion[:, :1] + np.arange(n_poses))
        for c, s in zip(clip, motion[:, 0]):
            seen[c].add(int(s))
    for i, n in enumerate(lens):
        assert seen[i] == set(range(max(n - n_poses, 1))), (i, seen[i])


def test_short_clip_raises(tmp_path):
    port_ds, _ = _stores(tmp_path, (40, 19), 20)
    with pytest.raises(ValueError, match="n_poses"):
        DeviceWindowCache.from_beat_twh(port_ds, "cpu")


# ---- gradients and steps against the JAX train step ----------------------------------


def make_models(mode, seed=0):
    """(flax MDMPlus, randomized params, the port's MDMPlus with the same weights)."""
    fmodel = jax_mdm_plus.MDMPlus(jax_mdm_plus.MDMPlusConfig(**KW, cond_mode=mode))
    x, cond, _ = JS.make_beat_cond_builder(mode, NSEED)(
        {k: jnp.asarray(v) for k, v in make_batch(0).items()})
    params = fmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((B,), jnp.int32), cond)
    params = {"params": randomize_flax_params(params["params"], seed)}
    model = MDMPlus(MDMPlusConfig(**KW, cond_mode=mode, impl="plain"))
    model.load_state_dict(mdm_plus_state_dict_from_flax(params))
    return fmodel, params, model


@pytest.mark.parametrize("mode", MODES)
def test_gradients_match_jax_leaf_by_leaf(mode):
    fmodel, params, model = make_models(mode)
    rng = np.random.default_rng(3)
    batch = make_batch(4)
    noise = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    t = rng.integers(0, NT, B)
    jx, jcond, jmask = JS.make_beat_cond_builder(mode, NSEED)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    tx, tcond, tmask = make_beat_cond_builder(mode, NSEED)(torch_batch(batch))

    def loss_fn(p):
        terms, _ = JG.training_losses(JSCHED, lambda x, tt: fmodel.apply(p, x, tt, jcond), jx,
                                      jnp.asarray(t), jnp.asarray(noise), jmask)
        return terms["loss"].mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    terms, _ = TG.training_losses(TSCHED, lambda x, tt: model(x, tt, tcond), tx,
                                  torch.from_numpy(t), torch.from_numpy(noise), tmask)
    loss = terms["loss"].mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = mdm_plus_state_dict_from_flax(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref) and len(ref) >= 20
    for k, g in ref.items():
        g = g.numpy()
        np.testing.assert_allclose(np32(grads[k]), g, rtol=1e-4, atol=1e-6 * np.abs(g).max(),
                                   err_msg=k)


class JaxPlusDraws:
    """The JAX train step's draws for a key: t and noise as the step splits
    them, and the condition drops recorded from MDMPlus's own `mask_cond`
    calls (style; in attention3 also the seed)."""

    def __init__(self, monkeypatch):
        self.drops = []
        real = jax_mdm_plus.mask_cond

        def recording(c, *, cond_mask_prob, train, uncond=None, rng=None):
            if train and cond_mask_prob > 0.0:
                self.drops.append(np.asarray(
                    jax.random.bernoulli(rng, cond_mask_prob, (c.shape[0], 1)))[:, 0])
            return real(c, cond_mask_prob=cond_mask_prob, train=train, uncond=uncond, rng=rng)

        monkeypatch.setattr(jax_mdm_plus, "mask_cond", recording)

    def take(self, key):
        rng_t, rng_noise, _, _ = jax.random.split(key, 4)
        t = np.asarray(jax.random.randint(rng_t, (B,), 0, NT))
        noise = np.asarray(jax.random.normal(rng_noise, (B, NJ, 1, T), jnp.float32))
        style = self.drops[0]
        seed = self.drops[1] if len(self.drops) > 1 else np.zeros(B, bool)
        self.drops = []
        return dict(t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                    cond_drop=(torch.from_numpy(style), torch.from_numpy(seed)))


@pytest.mark.parametrize("mode", MODES)
def test_three_steps_match_jax(monkeypatch, mode):
    fmodel, params, model = make_models(mode, seed=1)

    def apply(p, x, t, cond, train=False, rngs=None, uncond=None):
        return fmodel.apply(p, x, t, cond, train=train, rngs=rngs, uncond=uncond)

    jcfg = JS.TrainConfig(**STEP_CFG, dropout_rng_impl="threefry")
    jstep = JS.make_train_step(apply, JSCHED, jcfg, JS.make_beat_cond_builder(mode, NSEED))
    jstate = JS.create_train_state(params, jcfg, NT)
    tcfg = TrainConfig(**STEP_CFG)
    tstate = TrainState(model, tcfg, NT)
    tstep = make_train_step(TSCHED, tcfg, make_beat_cond_builder(mode, NSEED))
    draws = JaxPlusDraws(monkeypatch)
    noisy = {}
    lr = STEP_CFG["lr"]
    for i in range(3):
        batch, key = make_batch(10 + i), jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, batch, key)
        n_drops = len(draws.drops)
        assert n_drops == (2 if "attention3" in mode else 1)
        tm = tstep(tstate, torch_batch(batch), None, **draws.take(key))
        noise_floor_entries(tstate, noisy)
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=f"{i} {k}")
        assert_named_close(tstate.params.to_dict(tstate.params.data),
                           mdm_plus_state_dict_from_flax(jstate.params), f"step {i} params",
                           noisy, lr * tstate.step, **STEP_TOL)
        assert_named_close(tstate.ema_state_dict(),
                           mdm_plus_state_dict_from_flax(jstate.ema_params), f"step {i} ema",
                           noisy, lr * tstate.step, **STEP_TOL)
    assert tstate.step == 3 and int(tstate.optimizer.count) == 3
