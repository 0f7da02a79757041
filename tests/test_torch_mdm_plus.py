"""BEAT/TWH MDM+ / MDM++ denoiser of the PyTorch port vs the flax MDMPlus.

Small configuration as `tests/test_mdm_plus.py` builds it (2 layers, latent
128, ff 96, njoints 36, T 30, window 15, 5 seed frames); flax params are
randomized and crossed to the port through
`models/convert.py::mdm_plus_state_dict_from_flax`. For all three variants:

* `impl="plain"` against the JAX XLA path (`attn_impl="xla"`, flax trunk),
  conditioned and with a mixed CFG `uncond`, at atol 5e-4 (the
  converted-weight bar of `MIGRATION.md`; seen 1.7e-6 to 2.6e-6);
* `impl="kernel"` on CPU tensors (the kernels' plain versions) against the
  JAX Pallas path: `attn_impl="pallas"` and each trunk layer through
  `encoder_layer_pallas(mxu_bf16=False)`, both in interpret mode, at 5e-4
  (seen 1.7e-6 to 2.1e-6);
* under `uncond` only the style is dropped in variants 4 and 5 (the seed
  path still moves the output), style and seed in variant 3;
* the bf16 serving mode within RMS/std 2e-2 of the JAX bf16 model (bf16
  params, `dtype=bfloat16`, gelu_tanh), the bench gate's bar (seen 7.8e-3 to
  9.1e-3: the JAX model runs the local block in bf16 too, the port float32).

Also: the reference-layout state_dict round trip (port → JAX
`convert_mdm_beat_twh` → port) and a reference `.pt` loaded by
`load_reference_mdm_plus`; `validate()` raising on the JAX package's other
trunks and layouts; the training forward's drops; each variant's local block
spanning the 150 frames at the full BEAT and TWH widths.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusestylegesture_tpu.models import convert as jax_convert
from diffusestylegesture_tpu.models import mdm_plus as jax_mdm_plus
from diffusestylegesture_tpu.ops.encoder_layer_pallas import fused_trunk_apply
from diffusestylegesture_torch.models.convert import (load_reference_mdm_plus,
                                                      mdm_plus_state_dict_from_flax)
from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig, beat_mdm, twh_mdm
from diffusestylegesture_torch.sample import BeatEngineConfig, BeatTwhSampler
from diffusestylegesture_torch import diffusion as TD

from torch_port_utils import np32, randomize_flax_params

B, NJ, T, NSEED = 2, 36, 30, 5  # T divisible by window 15
KW = dict(njoints=NJ, latent_dim=128, ff_size=96, num_layers=2, source_audio_dim=40,
          audio_feat_dim=32, style_dim_in=4, n_seed=NSEED, window_size=15)
MODES = ["cross_local_attention3_style1", "cross_local_attention4_style1",
         "cross_local_attention5_style1"]
ATOL = 5e-4
BF16_TOL = 2e-2  # bench.py's gate of the bf16 serving mode


def _audio_len(mode):
    return T - NSEED * (int(mode[len("cross_local_attention")]) - 3)


def _inputs(mode, seed=0):
    rng = np.random.default_rng(seed)
    cond = {"style": rng.standard_normal((B, 4)).astype(np.float32),
            "seed": rng.standard_normal((B, NJ, 1, NSEED)).astype(np.float32),
            "audio": rng.standard_normal((B, _audio_len(mode), 40)).astype(np.float32),
            "mask_local": np.ones((B, T), bool)}
    if "attention5" in mode:
        cond["seed_last"] = rng.standard_normal((B, NJ, 1, NSEED)).astype(np.float32)
    x = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    return x, np.array([11, 999], np.int64), cond


def _jax(cond):
    return {k: jnp.asarray(v) for k, v in cond.items()}


def _torch(cond):
    return {k: torch.from_numpy(v) for k, v in cond.items()}


@pytest.fixture(scope="module", params=MODES, ids=["attention3", "attention4", "attention5"])
def models(request):
    mode = request.param
    fmodel = jax_mdm_plus.MDMPlus(jax_mdm_plus.MDMPlusConfig(**KW, cond_mode=mode))
    x, t, cond = _inputs(mode)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), _jax(cond))
    params = {"params": randomize_flax_params(params["params"], 0)}
    model = MDMPlus(MDMPlusConfig(**KW, cond_mode=mode)).eval()
    model.load_state_dict(mdm_plus_state_dict_from_flax(params))
    return mode, fmodel, params, model


def _port(model, impl, x, t, cond, uncond=None):
    model = model if model.cfg.impl == impl else _with(model, impl=impl)
    with torch.no_grad():
        return np32(model(torch.from_numpy(x), torch.from_numpy(t), _torch(cond),
                          uncond=None if uncond is None else torch.tensor(uncond)))


def _with(model, **changes):
    other = MDMPlus(dataclasses.replace(model.cfg, **changes)).eval()
    other.load_state_dict(model.state_dict())
    return other


@pytest.mark.parametrize("uncond", [None, [False, True]], ids=["cond", "cfg_mixed"])
def test_plain_matches_jax_xla(models, uncond):
    mode, fmodel, params, model = models
    x, t, cond = _inputs(mode, 1)
    ref = np.asarray(fmodel.apply(params, jnp.asarray(x), jnp.asarray(t), _jax(cond),
                                  uncond=None if uncond is None else jnp.asarray(uncond)))
    out = _port(model, "plain", x, t, cond, uncond)
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, f"{mode}: max abs err {err:.3e}"


def test_kernel_route_matches_jax_pallas(models, monkeypatch):
    """The kernel route on CPU tensors against the JAX model with kernel A
    (`attn_impl="pallas"`) and every trunk layer through kernel B's Pallas
    version, both in interpret mode."""
    mode, fmodel, params, model = models
    flax_trunk = jax_mdm_plus.encoder_trunk

    def pallas_trunk(parent, cfg, seq, train):
        if parent.is_initializing():
            return flax_trunk(parent, cfg, seq, train)
        return fused_trunk_apply(seq, parent.variables["params"]["seqTransEncoder"],
                                 cfg.num_heads, mxu_bf16=False)

    monkeypatch.setattr(jax_mdm_plus, "encoder_trunk", pallas_trunk)
    pallas = jax_mdm_plus.MDMPlus(dataclasses.replace(fmodel.cfg, attn_impl="pallas"))
    x, t, cond = _inputs(mode, 2)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas.apply(params, jnp.asarray(x), jnp.asarray(t), _jax(cond)))
    out = _port(model, "kernel", x, t, cond)
    err = float(np.abs(out - ref).max())
    assert err <= ATOL, f"{mode}: max abs err {err:.3e}"


def test_uncond_drops_only_the_style_in_variants_4_and_5(models):
    mode, _, _, model = models
    x, t, cond = _inputs(mode, 3)
    other = dict(cond, seed=cond["seed"] + 1.0)
    drop = [True, True]
    moved = np.abs(_port(model, "plain", x, t, cond, drop)
                   - _port(model, "plain", x, t, other, drop)).max()
    if "attention3" in mode:
        assert moved == 0.0  # the seed embedding is dropped with the style
    else:
        assert moved > 1e-3  # the seed frames are never dropped
    restyled = dict(cond, style=cond["style"] * 3.0)
    np.testing.assert_array_equal(_port(model, "plain", x, t, cond, drop),
                                  _port(model, "plain", x, t, restyled, drop))


def test_training_drops_match_uncond(models):
    """train=True with dropout 0: the drops given by `cond_drop` act as
    `uncond` does (style always; the seed in variant 3 only)."""
    mode, _, _, model = models
    x, t, cond = _inputs(mode, 4)
    plain = _with(model, impl="plain", dropout=0.0)
    ones = torch.ones(B, dtype=torch.bool)
    seed_drop = ones if "attention3" in mode else ~ones
    with torch.no_grad():
        trained = plain(torch.from_numpy(x), torch.from_numpy(t), _torch(cond), train=True,
                        cond_drop=(ones, seed_drop))
    np.testing.assert_allclose(np32(trained), _port(plain, "plain", x, t, cond, [True, True]),
                               atol=1e-6)
    with pytest.raises(ValueError, match="impl='plain'"):
        model(torch.from_numpy(x), torch.from_numpy(t), _torch(cond), train=True)


@pytest.mark.parametrize("uncond", [None, [False, True]], ids=["cond", "cfg_mixed"])
def test_precomputed_invariants_equal_the_per_step_forward(models, uncond):
    """`forward` on a `cond` that holds `cond_invariants(cond)` is bitwise the
    forward that computes them; without `uncond` it reads neither the style,
    the features nor the seed frames (poisoned with NaN, nothing changes)."""
    mode, _, _, model = models
    x, t, cond = _inputs(mode, 6)
    x, t, cond = torch.from_numpy(x), torch.from_numpy(t), _torch(cond)
    tu = None if uncond is None else torch.tensor(uncond)
    with torch.no_grad():
        inv = model.cond_invariants(cond)
        want = model(x, t, cond, uncond=tu)
        got = model(x, t, {**cond, **inv}, uncond=tu)
        poisoned = {k: v if k == "mask_local" else torch.full_like(v, float("nan"))
                    for k, v in cond.items()}
        blind = model(x, t, {**poisoned, **inv}) if uncond is None else want
    assert set(inv) == {"style_emb", "audio_emb"} | (
        {"seed_emb"} if "attention3" in mode else set())
    assert inv["audio_emb"].shape == (B, T, KW["audio_feat_dim"])
    assert torch.equal(got, want) and torch.equal(blind, want)


def test_train_forward_is_unchanged_by_invariants(models):
    """The training forward (drops drawn from the generator, dropout on)
    gives the same prediction whether `cond` holds the invariants or not."""
    mode, _, _, model = models
    x, t, cond = _inputs(mode, 7)
    x, t, cond = torch.from_numpy(x), torch.from_numpy(t), _torch(cond)
    plain = _with(model, impl="plain", cond_mask_prob=0.5)
    with torch.no_grad():
        inv = plain.cond_invariants(cond)
        outs = [plain(x, t, c, train=True, generator=torch.Generator().manual_seed(3))
                for c in (cond, {**cond, **inv})]
    assert torch.equal(outs[0], outs[1])


def test_bf16_mode_within_gate_of_jax_bf16(models):
    mode, fmodel, params, model = models
    x, t, cond = _inputs(mode, 5)
    fast = jax_mdm_plus.MDMPlus(dataclasses.replace(fmodel.cfg, dtype=jnp.bfloat16,
                                                    activation="gelu_tanh"))
    bf16_params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, params)
    ref = np.asarray(fast.apply(bf16_params, jnp.asarray(x), jnp.asarray(t), _jax(cond)),
                     np.float64)
    ref32 = np.asarray(fmodel.apply(params, jnp.asarray(x), jnp.asarray(t), _jax(cond)))
    out = _port(_with(model, dtype=torch.bfloat16, activation="gelu_tanh"), "kernel", x, t, cond)
    nrms = float(np.sqrt(np.mean((out - ref) ** 2)) / ref32.std())
    assert nrms <= BF16_TOL, f"{mode}: RMS/std {nrms:.3e}"


def test_reference_state_dict_round_trip(models, tmp_path):
    mode, _, _, model = models
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = mdm_plus_state_dict_from_flax(jax_convert.convert_mdm_beat_twh(sd, num_layers=2))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # a reference .pt: the CLIP weights and the buffers the port recomputes are not read
    ref_sd = dict(model.state_dict(), **{"clip_model.w": torch.zeros(3),
                                         "sequence_pos_encoder.pe": torch.zeros(5, 1, 128)})
    torch.save({"model_state_dict": ref_sd}, tmp_path / "model.pt")
    loaded = load_reference_mdm_plus(str(tmp_path / "model.pt"), model.cfg, device="cpu")
    x, t, cond = _inputs(mode, 6)
    np.testing.assert_array_equal(_port(loaded, "kernel", x, t, cond),
                                  _port(model, "kernel", x, t, cond))


@pytest.mark.parametrize("bad", [dict(moe_experts=2, trunk_impl="pipeline", pipe_mesh=object()),
                                 dict(trunk_impl="pipeline"),
                                 dict(split_qkv=True), dict(seq_parallel=True),
                                 dict(cond_mode="cross_local_attention6_style1")],
                         ids=["moe", "pipeline", "split_qkv", "seq_parallel", "cond_mode"])
def test_validate_raises_on_later_slices(bad):
    """What still raises since the parallel slice: MoE with a pipelined trunk
    (the JAX CLI refuses it too), a pipelined trunk or sequence-parallel
    attention without its mesh, an unknown variant. The split q/k/v layout
    builds, and from the packed weights gives the packed forward (the
    parallel paths themselves: `test_torch_parallel_*.py`)."""
    if bad.get("split_qkv"):
        from diffusestylegesture_torch.parallel.tp import split_qkv_params

        mode = "cross_local_attention4_style1"
        packed = MDMPlus(MDMPlusConfig(**KW, cond_mode=mode, impl="plain")).eval()
        split = MDMPlus(MDMPlusConfig(**{**KW, **bad}, cond_mode=mode, impl="plain")).eval()
        split.load_state_dict(split_qkv_params(packed.state_dict()))
        x, t, cond = _inputs(mode, 2)
        np.testing.assert_allclose(_port(split, "plain", x, t, cond),
                                   _port(packed, "plain", x, t, cond), atol=1e-5)
        return
    with pytest.raises(ValueError):
        MDMPlus(MDMPlusConfig(**{**KW, **bad}))


def test_validate_raises_on_impl_and_dtype():
    with pytest.raises(ValueError, match="impl"):
        MDMPlus(MDMPlusConfig(**KW, impl="xla"))
    with pytest.raises(ValueError, match="dtype"):
        MDMPlus(MDMPlusConfig(**KW, dtype=torch.float16))


@pytest.mark.parametrize("variant", ["attention3", "attention4", "attention5"])
@pytest.mark.parametrize("dataset", ["beat", "twh"])
def test_full_width_local_block_spans_150_frames(dataset, variant):
    """At the published widths (one trunk layer), the engine's window slices of
    each variant plus its seed frames give the local block 150 frames, which
    kernel A's window of 15 divides, and the denoiser returns a window."""
    mode = f"cross_local_attention{variant[-1]}_style1"
    torch.manual_seed(0)
    model = (beat_mdm if dataset == "beat" else twh_mdm)(cond_mode=mode, num_layers=1).eval()
    cfg = model.cfg
    sched = TD.Schedule.create(TD.named_beta_schedule("cosine", 4), device="cpu")
    engine = BeatTwhSampler(None, sched, BeatEngineConfig(
        njoints=cfg.njoints, audio_dim=cfg.source_audio_dim, variant=variant), device="cpu")
    rng = np.random.default_rng(7)
    windows, num, _ = engine.slice_windows(
        rng.standard_normal((250, cfg.source_audio_dim)).astype(np.float32))
    seeds = {"attention3": 0, "attention4": 1, "attention5": 2}[variant]
    assert num == 3 and windows.shape[1] + seeds * cfg.n_seed == 150 and 150 % 15 == 0
    cond = {"style": torch.eye(cfg.style_dim_in)[:1],
            "seed": torch.randn(1, cfg.njoints, 1, cfg.n_seed),
            "audio": torch.from_numpy(windows[1][None]),
            "mask_local": torch.ones(1, 150, dtype=torch.bool)}
    if variant == "attention5":
        cond["seed_last"] = torch.randn(1, cfg.njoints, 1, cfg.n_seed)
    with torch.no_grad():
        out = model(torch.randn(1, cfg.njoints, 1, 150), torch.tensor([500]), cond)
    assert out.shape == (1, cfg.njoints, 1, 150) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="frames"):
        model(torch.randn(1, cfg.njoints, 1, 150), torch.tensor([500]),
              dict(cond, audio=cond["audio"][:, 1:]))
