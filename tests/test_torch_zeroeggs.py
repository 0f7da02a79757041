"""ZeroEGGS networks of the PyTorch port vs the JAX package, on the CPU.

Tiny widths (5 joints, hidden 32, speech 12, style 8), flax init randomized
and crossed into the port through `models/convert.py::
zeroeggs_state_dict_from_flax`, inputs from numpy seeds. Held within 1e-5:
the speech encoder, the style VAE with its gru and attn encoders (the
reparameterization noise handed to both), the cell-state encoder, one
decoder step and a 30-frame rollout; within 1e-6: `quat.from_helical`,
`inv`, `mul`, `mul_vec` and `from_xform` at the decoder's shapes,
`kl_divergence` and `kl_weight`. The port's RAdam against `optax.radam`
over ten updates (both of its branches) within 1e-6; six train steps with
optax's RAdam against the port's: each loss within 1e-6 relative, the weights
after them within 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu.models import zeroeggs as JZ
from diffusestylegesture_tpu.motion import quat as jquat
from diffusestylegesture_torch.models import zeroeggs as TZ
from diffusestylegesture_torch.models.convert import zeroeggs_state_dict_from_flax
from diffusestylegesture_torch.motion import quat

from torch_port_utils import np32, randomize_flax_params

NJ, HID, SPEECH, STYLE, AUDIO = 5, 32, 12, 8, 7
POSE_IN, POSE_OUT = NJ * 15 + 9, NJ * 15 + 6


def _cfg(kind="gru"):
    kw = dict(njoints=NJ, pose_input_size=POSE_IN, pose_output_size=POSE_OUT,
              speech_encoding_size=SPEECH, style_embedding_size=STYLE, hidden_size=HID,
              style_encoder_type=kind)
    return JZ.ZeroEGGSConfig(**kw), TZ.ZeroEGGSConfig(**kw)


def _unit(rng, shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _state(rng, B):
    return (rng.standard_normal((B, 3)).astype(np.float32), _unit(rng, (B,)),
            rng.standard_normal((B, 3)).astype(np.float32) * 0.1,
            rng.standard_normal((B, 3)).astype(np.float32) * 0.1,
            rng.standard_normal((B, NJ, 3)).astype(np.float32),
            rng.standard_normal((B, NJ, 2, 3)).astype(np.float32),
            rng.standard_normal((B, NJ, 3)).astype(np.float32) * 0.1,
            rng.standard_normal((B, NJ, 3)).astype(np.float32) * 0.1)


def _stats(rng):
    return {"audio_input_mean": rng.standard_normal(AUDIO).astype(np.float32) * 0.1,
            "audio_input_std": rng.uniform(0.5, 2.0, AUDIO).astype(np.float32),
            "anim_input_mean": rng.standard_normal(POSE_IN).astype(np.float32) * 0.1,
            "anim_input_std": rng.uniform(0.5, 2.0, POSE_IN).astype(np.float32),
            "anim_output_mean": rng.standard_normal(POSE_OUT).astype(np.float32) * 0.1,
            "anim_output_std": rng.uniform(0.5, 2.0, POSE_OUT).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _nets(kind="gru"):
    """(flax modules, flax params {speech, style, decoder}, the port's ZeroEGGS)."""
    jcfg, tcfg = _cfg(kind)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    sp = JZ.SpeechEncoder(HID, SPEECH)
    st = JZ.StyleEncoderVAE(HID, STYLE, encoder_type=kind)
    dec = JZ.ZeroEGGSDecoder(jcfg)
    B, T = 2, 4
    stats = {k: jnp.asarray(v) for k, v in _stats(rng).items()}
    params = {
        "speech": sp.init(key, jnp.zeros((B, T, AUDIO))),
        "style": st.init(key, jnp.zeros((B, T, POSE_IN))),
        "decoder": dec.init(key, tuple(jnp.asarray(a) for a in _state(rng, B)),
                            jnp.zeros((B, T, 3)), jnp.zeros((B, T, SPEECH)),
                            jnp.zeros((B, T, STYLE)), stats["anim_input_mean"],
                            stats["anim_input_std"], stats["anim_output_mean"],
                            stats["anim_output_std"]),
    }
    params = {k: {"params": randomize_flax_params(v["params"], i + 1)}
              for i, (k, v) in enumerate(params.items())}
    model = TZ.ZeroEGGS(tcfg, AUDIO).eval()
    model.load_state_dict(zeroeggs_state_dict_from_flax(params))
    return (sp, st, dec), params, model


def _close(out, ref, tol=1e-5):
    out, ref = np32(out), np32(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, atol=tol * max(float(np.abs(ref).max()), 1.0))


T_ = torch.from_numpy


def test_quat_ops_match_jax():
    rng = np.random.default_rng(1)
    q, r = _unit(rng, (4, NJ)), _unit(rng, (4, NJ))
    v = rng.standard_normal((4, NJ, 3)).astype(np.float32)
    v[0, 0] = 0.0  # the small-angle branch
    v[1, 0] = 1e-7
    _close(quat.from_helical(T_(v)), jquat.from_helical(jnp.asarray(v)), 1e-6)
    _close(quat.inv(T_(q)), jquat.inv(jnp.asarray(q)), 1e-6)
    _close(quat.mul(T_(q), T_(r)), jquat.mul(jnp.asarray(q), jnp.asarray(r)), 1e-6)
    _close(quat.mul_vec(T_(q), T_(v)), jquat.mul_vec(jnp.asarray(q), jnp.asarray(v)), 1e-6)
    from diffusestylegesture_torch.motion import txform
    xf = txform.orthogonalize_from_xy(rng.standard_normal((30, NJ, 2, 3)).astype(np.float32))
    _close(quat.from_xform(xf), jquat.from_xform(jnp.asarray(xf)), 1e-6)


def test_speech_encoder_matches_jax():
    (sp, _, _), params, model = _nets()
    x = np.random.default_rng(2).standard_normal((2, 40, AUDIO)).astype(np.float32)
    with torch.no_grad():
        out = model.speech(T_(x))
    _close(out, sp.apply(params["speech"], jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["gru", "attn"])
def test_style_vae_matches_jax(kind):
    (_, st, _), params, model = _nets(kind)
    x = np.random.default_rng(3).standard_normal((2, 25, POSE_IN)).astype(np.float32)
    _, mu, logvar = st.apply(params["style"], jnp.asarray(x))
    key = jax.random.PRNGKey(4)
    z, _, _ = st.apply(params["style"], jnp.asarray(x), key=key, temperature=0.7)
    eps = np.array(jax.random.normal(key, (2, STYLE)))
    with torch.no_grad():
        tz_mu, tmu, tlogvar = model.style(T_(x))
        tz, _, _ = model.style(T_(x), temperature=0.7, eps=T_(eps))
    for out, ref in ((tmu, mu), (tlogvar, logvar), (tz_mu, mu), (tz, z)):
        _close(out, ref)


def _decoder_inputs(seed, B=2, T=30):
    rng = np.random.default_rng(seed)
    return (_state(rng, B), rng.standard_normal((B, T, 3)).astype(np.float32),
            rng.standard_normal((B, T, SPEECH)).astype(np.float32),
            rng.standard_normal((B, T, STYLE)).astype(np.float32),
            _stats(np.random.default_rng(0)))


def test_cell_encoder_step_and_rollout_match_jax():
    (_, _, dec), params, model = _nets()
    state, gaze, speech, style, stats = _decoder_inputs(5)
    jstats = [jnp.asarray(stats[k]) for k in TZ.STAT_KEYS]
    tstats = {k: T_(v) for k, v in stats.items()}
    p = params["decoder"]["params"]
    jcell = JZ.CellStateEncoder(HID, 2).apply({"params": p["cell_state_encoder"]},
                                              jnp.asarray(state[0][:, :1].repeat(POSE_IN, 1)),
                                              jnp.asarray(style[:, 0]))
    with torch.no_grad():
        tcell = model.decoder.cell_state_encoder(T_(state[0][:, :1].repeat(POSE_IN, 1)),
                                                 T_(style[:, 0]))
    _close(tcell, jcell)

    pose = JZ.vectorize_input(*[jnp.asarray(a) for a in state], jnp.asarray(gaze[:, 1]),
                              *jstats[:2])
    rec = JZ.RecurrentDecoderNormal(HID, POSE_OUT, 2)
    jpred, jstates = rec.apply({"params": p["recurrent_decoder"]}, pose, jnp.asarray(speech[:, 1]),
                               jnp.asarray(style[:, 1]), jcell)
    jnext = JZ.devectorize_output(jpred, jnp.asarray(state[0]), jnp.asarray(state[1]), NJ,
                                  1.0 / 60.0, *jstats[2:])
    with torch.no_grad():
        carry = tuple(T_(a) for a in state) + (tcell,)
        tnext = model.decoder.step(carry, T_(speech[:, 1]), T_(style[:, 1]), T_(gaze[:, 1]),
                                   tstats)
    for out, ref in zip(tnext, tuple(jnext) + (jstates,)):
        _close(out, ref)

    ref = dec.apply(params["decoder"], tuple(jnp.asarray(a) for a in state), jnp.asarray(gaze),
                    jnp.asarray(speech), jnp.asarray(style), *jstats)
    with torch.no_grad():
        out = model.decoder([T_(a) for a in state], T_(gaze), T_(speech), T_(style), tstats)
    for o, r in zip(out, ref):
        assert o.shape[1] == 30
        _close(o, r)


def test_kl_matches_jax():
    rng = np.random.default_rng(6)
    mu = rng.standard_normal((3, STYLE)).astype(np.float32)
    logvar = rng.standard_normal((3, STYLE)).astype(np.float32) * 0.5
    _close(TZ.kl_divergence(T_(mu), T_(logvar)), JZ.kl_divergence(mu, logvar), 1e-6)
    for it in (0, 100, 7500, 8000, 20000):
        _close(TZ.kl_weight(it), JZ.kl_weight(it), 1e-6)


def _batch(rng, B, W):
    feats = _state(rng, B)
    tgt = _state(rng, B * W)
    return dict(
        initial_state=feats,
        gaze=rng.standard_normal((B, W, 3)).astype(np.float32),
        audio_features=rng.standard_normal((B, W, AUDIO)).astype(np.float32),
        style_example=rng.standard_normal((B, W, POSE_IN)).astype(np.float32),
        target_root_pos=tgt[0].reshape(B, W, 3), target_root_rot=tgt[1].reshape(B, W, 4),
        target_lpos=tgt[4].reshape(B, W, NJ, 3), target_ltxy=tgt[5].reshape(B, W, NJ, 2, 3))


def test_radam_matches_optax_through_the_rectification():
    """Ten updates of one parameter vector from seeded gradients: the first
    four take optax's unrectified branch (ro < 5), the rest the rectified one."""
    import optax

    from diffusestylegesture_torch.train.state import FlatParams

    rng = np.random.default_rng(9)
    p0 = rng.standard_normal(50).astype(np.float32)
    module = torch.nn.Linear(5, 10, bias=False)
    with torch.no_grad():
        module.weight.copy_(T_(p0.reshape(10, 5)))
    flat = FlatParams(module)
    opt = TZ.RAdam(flat, 3e-3)
    tx = optax.radam(3e-3)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for _ in range(10):
        g = rng.standard_normal(50).astype(np.float32)
        flat.grad.copy_(T_(g))
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        _close(flat.data, jp, 1e-6)


def test_six_radam_train_steps_match_jax():
    nets, params, _ = _nets()
    _, tcfg = _cfg()
    model = TZ.ZeroEGGS(tcfg, AUDIO)
    model.load_state_dict(zeroeggs_state_dict_from_flax(params))
    stats = _stats(np.random.default_rng(0))
    init_fn, step_fn = JZ.make_zeroeggs_train_step(*nets, {k: jnp.asarray(v) for k, v in
                                                           stats.items()}, lr=1e-3)
    step_fn = jax.jit(step_fn)
    opt_state = init_fn(params)
    tstep = TZ.ZeroEggsTrainStep(model, {k: T_(v) for k, v in stats.items()}, lr=1e-3)
    rng = np.random.default_rng(7)
    key = jax.random.PRNGKey(8)
    for i in range(6):  # RAdam rectifies from its fifth step on
        batch = _batch(rng, 2, 8)
        key, sub = jax.random.split(key)
        jb = {k: (tuple(jnp.asarray(a) for a in v) if k == "initial_state" else jnp.asarray(v))
              for k, v in batch.items()}
        params, opt_state, aux = step_fn(params, opt_state, jb, sub, i)
        tb = {k: (tuple(T_(a) for a in v) if k == "initial_state" else T_(v))
              for k, v in batch.items()}
        eps = T_(np.array(jax.random.normal(sub, (2, STYLE))))
        out = tstep.step(tb, None, i, eps=eps)
        for name in ("loss", "rec", "kl", "kl_weight"):
            np.testing.assert_allclose(float(out[name]), float(aux[name]), rtol=1e-6, atol=1e-7)
    ref = zeroeggs_state_dict_from_flax(jax.tree.map(np.asarray, params))
    own = model.state_dict()
    assert set(ref) == set(own)
    for name in ref:
        _close(own[name], ref[name])
    assert int(tstep.opt.count) == 6


def test_buffered_rollout_step_equals_the_decoder_forward():
    """The step `sample/engine_zeroeggs.py` captures on the card, run eagerly
    over its buffers, gives the decoder's forward bitwise."""
    from diffusestylegesture_torch.sample.engine_zeroeggs import CapturedRollout

    _, _, model = _nets()
    state, gaze, speech, style, stats = _decoder_inputs(11)
    tstats = {k: T_(v) for k, v in stats.items()}
    args = ([T_(a) for a in state], T_(gaze), T_(speech), T_(style), tstats)
    with torch.no_grad():
        ref = model.decoder(*args)
    rollout = CapturedRollout(model.decoder, torch.device("cpu"), graphs=False)
    for _ in range(2):  # the buffers are refilled on the second call
        out = rollout(*args)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)


def test_style_blending_and_example_features_match_jax():
    from diffusestylegesture_torch.sample import engine_zeroeggs as TE
    from diffusestylegesture_tpu.sample import engine_zeroeggs as JE

    rng = np.random.default_rng(12)
    encs = [rng.standard_normal((1, STYLE)).astype(np.float32) for _ in range(3)]
    for blend, ratio in (("add", None), ("add", [0.2, 0.3, 0.5]), ("stitch", [0.4, 0.4, 0.2]),
                         ("stitch", None)):
        ref = JE.blend_style_encodings([jnp.asarray(e) for e in encs], 37, blend, ratio)
        out = TE.blend_style_encodings([T_(e) for e in encs], 37, blend, ratio)
        _close(out, ref, 1e-6)
    single = TE.blend_style_encodings([T_(encs[0])], 5)
    np.testing.assert_array_equal(single.numpy(), np.broadcast_to(encs[0][:, None], (1, 5, STYLE)))
    for n, ratios in ((37, [1, 1, 1]), (10, [0.05, 0.9, 0.05]), (4, [1.0])):
        for a, b in zip(TE.split_by_ratio(n, ratios), JE.split_by_ratio(n, ratios)):
            np.testing.assert_array_equal(a, b)
    parts = [rng.standard_normal((6,) + s).astype(np.float32)
             for s in ((3,), (3,), (NJ, 3), (NJ, 2, 3), (NJ, 3), (NJ, 3))]
    m, s = rng.standard_normal(POSE_IN).astype(np.float32), rng.uniform(0.5, 2, POSE_IN)
    np.testing.assert_array_equal(TE.example_feature_vec(*parts, m, s),
                                  np.asarray(JE.example_feature_vec(*parts, m, s)))
    with pytest.raises(ValueError, match="blend"):
        TE.blend_style_encodings([T_(e) for e in encs], 5, "mix")
