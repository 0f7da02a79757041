"""BEAT/TWH windowed engine of the PyTorch port vs the JAX `BeatTwhSampler`.

A tiny MDMPlus of each variant on shared weights (flax init, randomized,
crossed through `models/convert.py::mdm_plus_state_dict_from_flax`), the same
fused features, seed clip, style and injected per-window x_T; for the
ancestral DDPM loop the JAX loop's own per-step draws are replayed into the
port's programs. Final un-normalized poses agree within 2e-3 relative (the
`PARITY.md` windowed-engine bar) for DDPM and DDIM over a 10-step respaced
schedule, and DDIM at guidance 2. Window slicing and the seed preparation
are exact; window buckets leave the output unchanged; attention5 reads its
`seed_last` afresh on every call.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.models import mdm_plus as jax_mdm_plus
from diffusestylegesture_tpu.sample import engine_beat as jax_engine
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.diffusion.sampling import SampleProgram
from diffusestylegesture_torch.models.convert import mdm_plus_state_dict_from_flax
from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig
from diffusestylegesture_torch.sample import engine_beat as torch_engine

from torch_port_utils import randomize_flax_params

NJ, N_POSES, N_SEED, AUDIO, STYLE, REAL_N, STEPS = 36, 30, 5, 40, 4, 60, 10
MDM_KW = dict(njoints=NJ, latent_dim=96, ff_size=64, num_layers=2, source_audio_dim=AUDIO,
              audio_feat_dim=32, style_dim_in=STYLE, n_seed=N_SEED, window_size=15)
VARIANTS = ["attention3", "attention4", "attention5"]
WINDOWS = -(-REAL_N // (N_POSES - N_SEED))  # 3


def _mode(variant):
    return f"cross_local_attention{variant[-1]}_style1"


@functools.lru_cache(maxsize=None)
def _shared(variant):
    rng = np.random.default_rng(0)
    fm = jax_mdm_plus.MDMPlus(jax_mdm_plus.MDMPlusConfig(**MDM_KW, cond_mode=_mode(variant)))
    a_len = N_POSES - N_SEED * (int(variant[-1]) - 3)
    cond = {"style": jnp.zeros((1, STYLE)), "seed": jnp.zeros((1, NJ, 1, N_SEED)),
            "audio": jnp.zeros((1, a_len, AUDIO)), "mask_local": jnp.ones((1, N_POSES), bool)}
    if variant == "attention5":
        cond["seed_last"] = cond["seed"]
    params = jax.jit(fm.init)(jax.random.PRNGKey(2), jnp.zeros((1, NJ, 1, N_POSES)),
                              jnp.zeros((1,), jnp.int32), cond)
    params = {"params": randomize_flax_params(params["params"], 2)}
    model = MDMPlus(MDMPlusConfig(**MDM_KW, cond_mode=_mode(variant))).eval()
    model.load_state_dict(mdm_plus_state_dict_from_flax(params))
    motion_dim = NJ // 3
    raw = rng.standard_normal((N_SEED + 2, motion_dim)).astype(np.float32)
    mean = rng.standard_normal(motion_dim).astype(np.float32)
    std = (0.5 + rng.random(motion_dim)).astype(np.float32)
    return dict(
        variant=variant, fm=fm, params=params, model=model, mean=mean, std=std,
        textaudio=rng.standard_normal((REAL_N, AUDIO)).astype(np.float32),
        seed=jax_engine.prepare_seed_gesture(raw, mean, std),
        seed_last=rng.standard_normal((N_SEED, NJ)).astype(np.float32),
        noise=rng.standard_normal((WINDOWS, 1, NJ, 1, N_POSES)).astype(np.float32))


@pytest.fixture(params=VARIANTS)
def shared(request):
    return _shared(request.param)


def _cfg(module, variant, sampler, guidance=0.0):
    kw = dict(n_poses=N_POSES, n_seed=N_SEED, njoints=NJ, audio_dim=AUDIO, variant=variant,
              sampler=sampler, guidance_scale=guidance)
    return module.BeatEngineConfig(**kw)


def _torch_sampler(variant, sampler, guidance=0.0):
    betas = TD.named_beta_schedule("cosine", 1000)
    sched = TD.spaced_schedule(betas, TD.space_timesteps(1000, f"ddim{STEPS}"), device="cpu")
    return torch_engine.BeatTwhSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                                       sched, _cfg(torch_engine, variant, sampler, guidance),
                                       device="cpu")


def _jax_window_draws(key, num_windows, shape):
    """Each window's per-step draws of the JAX engine's loop for `key`: the
    engine splits a subkey per window, the loop one key for x_T and then one
    per step."""
    out = []
    for _ in range(num_windows):
        key, sub = jax.random.split(key)
        sub, _ = jax.random.split(sub)
        draws = []
        for _ in range(STEPS):
            sub, nkey = jax.random.split(sub)
            draws.append(np.array(jax.random.normal(nkey, shape, dtype=jnp.float32)))
        out.append(draws)
    return out


def _replay_draws(monkeypatch, windows):
    """Make each window's program (one `init` a window) draw the given arrays."""
    pending = iter(windows)
    init = SampleProgram.init

    def init_with_draws(self, noise=None, init_image=None):
        self._draws = iter(next(pending))
        init(self, noise, init_image)

    monkeypatch.setattr(SampleProgram, "init", init_with_draws)
    monkeypatch.setattr(SampleProgram, "_randn", lambda self: torch.from_numpy(next(self._draws)))


def _seed_last(s):
    return s["seed_last"] if s["variant"] == "attention5" else None


@pytest.mark.parametrize("sampler,guidance", [("ddpm", 0.0), ("ddim", 0.0), ("ddim", 2.0)],
                         ids=["ddpm", "ddim", "ddim_cfg2"])
def test_generate_matches_jax(shared, sampler, guidance, monkeypatch):
    s = shared
    betas = JD.named_beta_schedule("cosine", 1000)
    jsched = JD.spaced_schedule(betas, JD.space_timesteps(1000, f"ddim{STEPS}"))
    jsampler = jax_engine.BeatTwhSampler(
        lambda p, x, t, c, uncond=None: s["fm"].apply(p, x, t, c, uncond=uncond), jsched,
        _cfg(jax_engine, s["variant"], sampler, guidance))
    style = np.eye(STYLE, dtype=np.float32)[[2]]
    key = jax.random.PRNGKey(11)
    ref = jsampler.generate(s["params"], s["textaudio"], s["seed"], style, key, s["mean"],
                            s["std"], seed_last=_seed_last(s), noise_windows=s["noise"])
    _replay_draws(monkeypatch, _jax_window_draws(key, WINDOWS, (1, NJ, 1, N_POSES)))
    out = _torch_sampler(s["variant"], sampler, guidance).generate(
        s["model"], s["textaudio"], s["seed"], style, None, s["mean"], s["std"],
        seed_last=_seed_last(s), noise_windows=s["noise"])
    assert out.shape == ref.shape == (1, REAL_N, NJ // 3)
    scale = max(float(np.abs(ref).mean()), 1.0)
    err = float(np.abs(out - ref).max())
    assert err < 2e-3 * scale, f"max abs err {err} (scale {scale})"


def test_window_buckets_leave_output_unchanged(shared):
    s = shared
    style = np.eye(STYLE, dtype=np.float32)[[0, 3]]
    noise = np.concatenate([s["noise"], s["noise"]], axis=1)
    sampler = _torch_sampler(s["variant"], "ddim")
    args = (s["model"], s["textaudio"], s["seed"], style, None, s["mean"], s["std"])
    plain = sampler.generate(*args, seed_last=_seed_last(s), noise_windows=noise)
    bucketed = sampler.generate(*args, seed_last=_seed_last(s), noise_windows=noise,
                                window_buckets=(1, 4, 8))
    np.testing.assert_array_equal(bucketed, plain)


def test_seed_last_is_read_on_every_call():
    """attention5's second conditioning input lies in a buffer of the engine:
    a later call with another seed_last gives what a fresh engine gives."""
    s = _shared("attention5")
    style = np.eye(STYLE, dtype=np.float32)[[1]]
    args = (s["model"], s["textaudio"], s["seed"], style, None, s["mean"], s["std"])
    other = s["seed_last"][::-1].copy()
    sampler = _torch_sampler("attention5", "ddim")
    first = sampler.generate(*args, seed_last=s["seed_last"], noise_windows=s["noise"])
    second = sampler.generate(*args, seed_last=other, noise_windows=s["noise"])
    fresh = _torch_sampler("attention5", "ddim").generate(*args, seed_last=other,
                                                          noise_windows=s["noise"])
    assert np.abs(first - second).max() > 1e-3
    np.testing.assert_array_equal(second, fresh)
    with pytest.raises(ValueError, match="seed_last"):
        sampler.generate(*args)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("real_n", [1, 119, 120, 121, 360, 487])
def test_slice_windows_exact(variant, real_n):
    rng = np.random.default_rng(real_n)
    ta = rng.standard_normal((real_n, 1435)).astype(np.float32)
    sched = TD.Schedule.create(TD.named_beta_schedule("cosine", 4), device="cpu")
    ours = torch_engine.BeatTwhSampler(None, sched, torch_engine.BeatEngineConfig(
        variant=variant), device="cpu").slice_windows(ta)
    theirs = jax_engine.BeatTwhSampler(None, JD.Schedule.create(
        JD.named_beta_schedule("cosine", 4)), jax_engine.BeatEngineConfig(
        variant=variant)).slice_windows(ta)
    assert ours[1:] == theirs[1:]
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_prepare_seed_gesture_exact():
    rng = np.random.default_rng(5)
    raw = rng.standard_normal((40, 744)).astype(np.float32)[:32]
    mean = rng.standard_normal(744).astype(np.float32)
    std = (0.5 + rng.random(744)).astype(np.float32)
    ours = torch_engine.prepare_seed_gesture(raw, mean, std)
    assert ours.shape == (30, 2232) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_engine.prepare_seed_gesture(raw, mean, std))


def test_mesh_raises_and_unknown_variant():
    """A serving mesh without a `data` axis raises (`mesh=` serving itself:
    `test_torch_parallel_serving.py`), as does an unknown variant."""
    from diffusestylegesture_torch.parallel import make_mesh

    sampler = _torch_sampler("attention4", "ddim")
    with pytest.raises(ValueError, match="data"):
        sampler.generate(_shared("attention4")["model"], np.zeros((10, AUDIO), np.float32),
                         np.zeros((N_SEED, NJ)), np.eye(STYLE)[:1], None, 0.0, 1.0,
                         mesh=make_mesh(("model",), devices=[torch.device("cpu")]))
    with pytest.raises(ValueError, match="variant"):
        _torch_sampler("attention6", "ddim")
