"""The other models of the PyTorch port vs the JAX package's, at small sizes.

TISA (`models/tisa.py`), the local-attention `LocalTransformer`
(`models/local_transformer.py`), the reference's baseline generators
(`models/baselines.py`), the 1-D U-Net diffusion baseline
(`models/unet1d.py`) and the DiffWave baseline (`models/diffwav.py`). Both
sides get the same seeded weights: flax params, randomized, crossed by the
`*_state_dict_from_flax` of `models/convert.py` (BatchNorm variances kept
positive). Forwards agree at 1e-5 (scaled by the output's magnitude where it
exceeds 1), TISA at 1e-6; the losses and the samplers with the JAX draws
recomputed from its keys and injected (t, noise, the self-conditioning
coin, x_T and each step's noise, `generate`'s categorical draws) at 1e-5.
The DiffWave sampler of the JAX package runs with jit disabled, op by op as
the port runs: compiled, XLA's sine of the step embedding's large arguments
(t · 10^4) differs from the op-by-op value by up to 7e-4, which the port
matches at 1e-7. The U-Net sampler's reference is the JAX sampler's steps (its denoiser and
`p_mean_variance`) in float64 on the same float32 draws and schedule tables: over the 12 clipped
ancestral steps float32 drifts from it by 5e-6 in the port and 1.2e-5 in the
JAX function.
The reference-layout loader takes the port's own state_dict back through the
JAX `convert_*`. BatchNorm in train mode: the port's `WavEncoder` against the
same stack built with flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`: the
normalized output at 1e-5, the running mean at 1e-6 and the running
variance, which torch keeps unbiased, at 1e-6 after the n / (n − 1)
correction.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from diffusestylegesture_tpu.models import baselines as jb
from diffusestylegesture_tpu.models import diffwav as jdw
from diffusestylegesture_tpu.models import local_transformer as jlt
from diffusestylegesture_tpu.models import tisa as jtisa
from diffusestylegesture_tpu.models import unet1d as jun
from diffusestylegesture_torch.models import baselines as tb
from diffusestylegesture_torch.models import diffwav as tdw
from diffusestylegesture_torch.models import local_transformer as tlt
from diffusestylegesture_torch.models import tisa as ttisa
from diffusestylegesture_torch.models import unet1d as tun
from diffusestylegesture_torch.models.convert import (baseline_state_dict_from_flax,
                                                      diffwav_state_dict_from_flax,
                                                      generator_diff_state_dict_from_flax,
                                                      local_transformer_state_dict_from_flax,
                                                      tisa_state_dict_from_flax)

from torch_port_utils import np32, randomize_flax_params

S_SHORT = 3263  # raw samples the WavEncoder maps to 16 frames


def _params(module, *args, seed=0):
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)["params"]
    params = randomize_flax_params(params, seed)

    def positive_var(path, a):
        return np.abs(a) + 0.5 if str(getattr(path[-1], "key", "")) == "bn_var" else a

    return {"params": jax.tree_util.tree_map_with_path(positive_var, params)}


def _close(out, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np32(out), ref, atol=tol * max(1.0, float(np.abs(ref).max())))


def _load(model, sd):
    model.load_state_dict(sd)
    return model.eval()


def test_tisa_matches_jax():
    jm = jtisa.Tisa(num_attention_heads=4, num_kernels=5)
    params = jm.init(jax.random.PRNGKey(0), 240)
    ref = jm.apply(params, 240)
    model = _load(ttisa.Tisa(4, 5), tisa_state_dict_from_flax(params))
    with torch.no_grad():
        out = model(240)
    assert out.shape == (4, 240, 240)
    np.testing.assert_allclose(np32(out), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert not ttisa.Tisa(3, 0)(7).any()


LT = dict(num_tokens=40, max_seq_len=64, dim=32, depth=2, local_attn_window_size=8, dim_head=8,
          heads=4)


def _lt():
    jm = jlt.LocalTransformer(**LT)
    tokens = np.random.default_rng(0).integers(0, 40, (2, 21))
    params = _params(jm, jnp.asarray(tokens))
    return jm, params, _load(tlt.LocalTransformer(**LT),
                             local_transformer_state_dict_from_flax(params))


@pytest.mark.parametrize("n", [21, 24], ids=["autopad", "divisible"])
def test_local_transformer_logits_and_loss_match_jax(n):
    jm, params, model = _lt()
    rng = np.random.default_rng(n)
    tokens = rng.integers(0, 40, (2, n))
    mask = np.ones((2, n), bool)
    mask[1, :3] = False
    labels_ignored = tokens.copy()
    labels_ignored[0, -1] = -1  # an ignored target (only the last token is never an input)
    for m in (None, mask):
        jmask = None if m is None else jnp.asarray(m)
        tmask = None if m is None else torch.from_numpy(m)
        ref = jm.apply(params, jnp.asarray(tokens), jmask)
        with torch.no_grad():
            out = model(torch.from_numpy(tokens), tmask)
        _close(out, ref)
        jloss = jm.apply(params, jnp.asarray(labels_ignored), jmask, return_loss=True)
        with torch.no_grad():
            loss = model(torch.from_numpy(labels_ignored), tmask, return_loss=True)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_local_transformer_generate_with_injected_draws_matches_jax():
    jm, params, model = _lt()
    prime = np.random.default_rng(1).integers(0, 40, (2, 5))
    key = jax.random.PRNGKey(4)
    ref = jlt.generate(jm, params, jnp.asarray(prime), 4, key, temperature=0.9,
                       filter_thres=0.7)
    keys = []
    k = key
    for _ in range(4):
        k, sub = jax.random.split(k)
        keys.append(sub)
    it = iter(keys)

    def categorical(logits):
        return torch.from_numpy(np.asarray(jax.random.categorical(
            next(it), jnp.asarray(logits.numpy()), axis=-1)))

    out = tlt.generate(model, torch.from_numpy(prime), 4, temperature=0.9, filter_thres=0.7,
                       categorical=categorical)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    drawn = tlt.generate(model, torch.from_numpy(prime), 6,
                         generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 6) and (drawn >= 0).all() and (drawn < 40).all()


def test_local_transformer_helpers_match_jax():
    logits = np.random.default_rng(2).standard_normal((3, 7, 20)).astype(np.float32)
    for thres in (0.9, 0.5, 0.99):
        np.testing.assert_array_equal(
            tlt.top_k_filter(torch.from_numpy(logits), thres).numpy(),
            np.asarray(jlt.top_k_filter(jnp.asarray(logits), thres)))
    labels = np.random.default_rng(3).integers(-1, 20, (3, 7))
    np.testing.assert_allclose(
        float(tlt.cross_entropy_ignore(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jlt.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    assert float(tlt.cross_entropy_ignore(torch.zeros(1, 3, 5),
                                          torch.full((1, 3), -1))) == 0.0


def _wav(b=2, s=64000, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, s)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("name", ["linear", "gru"])
def test_generators_match_jax_and_load_reference_layout(name):
    wav = _wav()
    jcls, tcls, convert = {"linear": (jb.GeneratorLinear, tb.GeneratorLinear,
                                      jb.convert_generator_linear),
                           "gru": (jb.GeneratorGRU, tb.GeneratorGRU,
                                   jb.convert_generator_gru)}[name]
    jm = jcls()
    params = _params(jm, jnp.asarray(wav))
    model = _load(tcls(), baseline_state_dict_from_flax(params))
    target = np.random.default_rng(1).integers(0, 512, (2, 240))
    ref, jloss = jm.apply(params, jnp.asarray(wav), jnp.asarray(target) if name == "linear"
                          else None)
    with torch.no_grad():
        out, loss = model(torch.from_numpy(wav), torch.from_numpy(target))
    assert out.shape == (2, 240, 512)
    _close(out, ref)
    if name == "linear":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_array_equal(model.sample(torch.from_numpy(wav)).numpy(),
                                      np.asarray(jm.sample(params, jnp.asarray(wav))))
    # the reference layout: the port's own state_dict through the JAX converter
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    again = jm.apply({"params": convert(sd)}, jnp.asarray(wav))[0]
    _close(out, again)
    fresh = tb.load_reference_baseline(tcls(), model.state_dict()).eval()
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(wav))[0].numpy(), out.numpy())


def test_seq2seq_matches_jax():
    kw = dict(vocab=30, embed_size=12, hidden_size=48, pose_dim=10, n_frames=6)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 30, (3, 9))
    poses = rng.standard_normal((3, 6, 10)).astype(np.float32)
    jm = jb.Seq2SeqNet(**kw)
    params = _params(jm, jnp.asarray(tokens), jnp.asarray(poses))
    model = _load(tb.Seq2SeqNet(**kw), baseline_state_dict_from_flax(params))
    ref = jm.apply(params, jnp.asarray(tokens), jnp.asarray(poses))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens), torch.from_numpy(poses))
    assert out.shape == (3, 6, 10)
    _close(out, ref)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _close(out, jm.apply({"params": jb.convert_seq2seq(sd)}, jnp.asarray(tokens),
                         jnp.asarray(poses)))


class _TrainBNEncoder(fnn.Module):
    """The baselines' WavEncoder with flax's train-mode BatchNorm."""

    @fnn.compact
    def __call__(self, wav):
        x = wav[..., None]
        for i, (c, s, p) in enumerate(((16, 3, 800), (32, 3, 0), (64, 5, 0), (32, 6, 0))):
            x = fnn.Conv(c, (15,), strides=(s,), padding=[(p, p)], name=f"conv{i}")(x)
            if i < 3:
                x = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                                  name=f"bn{i}")(x)
                x = jax.nn.leaky_relu(x, 0.3)
        return x


def test_batchnorm_train_step_matches_flax():
    wav = _wav(4, 64000, seed=5)
    jm = _TrainBNEncoder()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(wav))
    params = randomize_flax_params(variables["params"], 3)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(4)
    stats = {k: {"mean": 0.1 * rng.standard_normal(v["mean"].shape).astype(np.float32),
                 "var": (0.5 + rng.random(v["var"].shape)).astype(np.float32)}
             for k, v in stats.items()}
    ref, new = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(wav),
                        mutable=["batch_stats"])
    enc = tb.WavEncoder()
    sd = {}
    for i, idx in enumerate((0, 3, 6, 9)):
        k = np.asarray(params[f"conv{i}"]["kernel"])
        sd[f"feat_extractor.{idx}.weight"] = torch.from_numpy(k.transpose(2, 1, 0).copy())
        sd[f"feat_extractor.{idx}.bias"] = torch.from_numpy(np.asarray(params[f"conv{i}"]["bias"]))
        if i < 3:
            bn = f"feat_extractor.{idx + 1}"
            sd[f"{bn}.weight"] = torch.from_numpy(np.asarray(params[f"bn{i}"]["scale"]))
            sd[f"{bn}.bias"] = torch.from_numpy(np.asarray(params[f"bn{i}"]["bias"]))
            sd[f"{bn}.running_mean"] = torch.from_numpy(stats[f"bn{i}"]["mean"])
            sd[f"{bn}.running_var"] = torch.from_numpy(stats[f"bn{i}"]["var"])
            sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    enc.load_state_dict(sd)
    enc.train()
    with torch.no_grad():
        out = enc(torch.from_numpy(wav))
    _close(out, ref)
    for i, idx in enumerate((1, 4, 7)):
        bn = enc.feat_extractor[idx]
        new_stats = new["batch_stats"][f"bn{i}"]
        np.testing.assert_allclose(np32(bn.running_mean), np.asarray(new_stats["mean"]),
                                   rtol=1e-6, atol=1e-6)
        # torch's running variance uses the unbiased batch variance (n values
        # a channel: batch × the layer's output frames)
        n = wav.shape[0] * {1: 21862, 4: 7283, 7: 1454}[idx]
        old = stats[f"bn{i}"]["var"]
        batch_var = (np.asarray(new_stats["var"]) - 0.9 * old) / 0.1
        want = 0.9 * old + 0.1 * batch_var * n / (n - 1)
        np.testing.assert_allclose(np32(bn.running_var), want, rtol=1e-6, atol=1e-6)
        assert int(bn.num_batches_tracked) == 1


@functools.lru_cache(maxsize=None)
def _gd():
    kw = dict(seq_len=16, joints=3, n_dim=3, dim=16, dim_mults=(1, 2), timesteps=12)
    jm = jun.GeneratorDiff(**kw)
    wav = _wav(2, S_SHORT, seed=6)
    x = np.random.default_rng(7).standard_normal((2, 16, 9)).astype(np.float32)
    params = _params(jm, jnp.asarray(x), jnp.zeros((2,), jnp.int32), jnp.asarray(wav))
    model = _load(tun.GeneratorDiff(**kw), generator_diff_state_dict_from_flax(params))
    jsched = jun.make_generator_diff_schedule(12)
    tsched = tun.make_generator_diff_schedule(12, device="cpu")
    return jm, params, model, jsched, tsched, wav, x


def test_generator_diff_forward_matches_jax():
    jm, params, model, _, _, wav, x = _gd()
    t = np.array([3, 11])
    sc = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    apply = jax.jit(jm.apply)
    for self_cond in (None, sc):
        ref = apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(wav),
                    None if self_cond is None else jnp.asarray(self_cond))
        with torch.no_grad():
            out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(wav),
                        None if self_cond is None else torch.from_numpy(self_cond))
        assert out.shape == (2, 16, 9)
        _close(out, ref)


def _jax_sample_f64(jm, params, wav, x_T, steps):
    """`unet1d.generator_diff_sample`'s steps in float64 (its scan carries are
    float32): the JAX package's denoiser and `p_mean_variance` on the given
    draws, with self-conditioning carried."""
    from diffusestylegesture_tpu.diffusion import gaussian as JG

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        sched = jun.make_generator_diff_schedule(12)
        feat = jm.apply(p64, jnp.asarray(wav, jnp.float64), method=jun.GeneratorDiff.encode_audio)
        denoise = jax.jit(functools.partial(jm.apply, method=jun.GeneratorDiff.denoise))
        img = jnp.asarray(x_T, jnp.float64)
        x_sc = jnp.zeros_like(img)
        for i, step in enumerate(range(11, -1, -1)):
            t = jnp.full((2,), step, jnp.int32)
            v = denoise(p64, img, t, feat, x_sc)
            out = JG.p_mean_variance(sched, v, img, t, mean_type=JG.MeanType.VELOCITY,
                                     var_type=JG.VarType.FIXED_SMALL, clip_denoised=True)
            img = out.mean + float(step != 0) * jnp.exp(0.5 * out.log_variance) * steps[i]
            x_sc = out.pred_xstart
        return np.asarray(img)


@pytest.mark.parametrize("key", [0, 3], ids=["key0", "key3"])  # coin: no / self-conditioning
def test_generator_diff_loss_and_sample_with_injected_draws_match_jax(key):
    jm, params, model, jsched, tsched, wav, x = _gd()
    k = jax.random.PRNGKey(key)
    jloss = jun.generator_diff_loss(jm, params, jsched, jnp.asarray(x), jnp.asarray(wav), k)
    tkey, nkey, sckey = jax.random.split(k, 3)
    t = np.asarray(jax.random.randint(tkey, (2,), 0, 12))
    noise = np.asarray(jax.random.normal(nkey, x.shape))
    use_sc = bool(jax.random.bernoulli(sckey, 0.5))
    loss = tun.generator_diff_loss(model, tsched, torch.from_numpy(x), torch.from_numpy(wav),
                                   t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                                   use_sc=use_sc)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for n, p in model.unet.named_parameters())

    kk, ikey = jax.random.split(k)  # the JAX sampler's draws
    x_T = np.asarray(jax.random.normal(ikey, (2, 16, 9), dtype=jnp.float32))
    steps = []
    for _ in range(12):
        kk, nk = jax.random.split(kk)
        steps.append(np.asarray(jax.random.normal(nk, (2, 16, 9), dtype=jnp.float32)))
    ref = _jax_sample_f64(jm, params, wav, x_T, steps)
    model64 = copy.deepcopy(model).double()
    sched64 = dataclasses.replace(tsched, **{
        f.name: getattr(tsched, f.name).double() for f in dataclasses.fields(tsched)
        if getattr(tsched, f.name).is_floating_point()})
    out64 = tun.generator_diff_sample(model64, sched64, torch.from_numpy(wav).double(),
                                      x_T=torch.from_numpy(x_T).double(),
                                      step_noise=torch.from_numpy(np.stack(steps)).double())
    assert out64.shape == (2, 16, 9)
    _close(out64, ref)
    out = tun.generator_diff_sample(model, tsched, torch.from_numpy(wav),
                                    x_T=torch.from_numpy(x_T),
                                    step_noise=torch.from_numpy(np.stack(steps)))
    _close(out, jun.generator_diff_sample(jm, params, jsched, jnp.asarray(wav), k), 5e-5)


@functools.lru_cache(maxsize=None)
def _dw():
    kw = dict(seq_len=16, channels=9, residual_channels=8, residual_layers=3, dilation_cycle=2)
    jm = jdw.DiffWavModel(**kw)
    wav = _wav(2, S_SHORT, seed=9)
    x = np.random.default_rng(10).standard_normal((2, 16, 9)).astype(np.float32)
    params = _params(jm, jnp.asarray(x), jnp.zeros((2,), jnp.float32), jnp.asarray(wav))
    return jm, params, _load(tdw.DiffWavModel(**kw), diffwav_state_dict_from_flax(params)), wav, x


def test_diffwav_forward_loss_and_sample_match_jax():
    jm, params, model, wav, x = _dw()
    t = np.array([2.5, 40.0], np.float32)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(wav))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(wav))
    _close(out, ref)
    np.testing.assert_allclose(tdw.diffwav_aligned_T(tdw.diffwav_beta_schedule(),
                                                     tdw.diffwav_beta_schedule(8, 0.3)),
                               jdw.diffwav_aligned_T(jdw.diffwav_beta_schedule(),
                                                     jdw.diffwav_beta_schedule(8, 0.3)))
    key = jax.random.PRNGKey(11)
    jloss = jdw.diffwav_training_loss(jm, params, jnp.asarray(x), jnp.asarray(wav), key)
    tkey, nkey = jax.random.split(key)
    tt = np.asarray(jax.random.randint(tkey, (2,), 0, 50))
    noise = np.asarray(jax.random.normal(nkey, x.shape))
    loss = tdw.diffwav_training_loss(model, torch.from_numpy(x), torch.from_numpy(wav),
                                     t=torch.from_numpy(tt), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    beta = jdw.diffwav_beta_schedule(6, 0.2)
    with jax.disable_jit():
        ref = jdw.diffwav_sample(jm, params, jnp.asarray(wav), key, beta=beta)
    kk, ikey = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(ikey, (2, 16, 9)))
    steps = []
    for _ in range(6):
        kk, nk = jax.random.split(kk)
        steps.append(np.asarray(jax.random.normal(nk, (2, 16, 9))))
    out = tdw.diffwav_sample(model, torch.from_numpy(wav), beta=beta, x_T=torch.from_numpy(x_T),
                             step_noise=torch.from_numpy(np.stack(steps)))
    _close(out, ref)
    assert float(out.abs().max()) <= 1.0
