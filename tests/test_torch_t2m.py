"""Text-to-motion modules of the PyTorch port vs the JAX package, at small widths.

* `utils/rotations.py` (pytorch3d convention, 6D = matrix rows) at 1e-6.
* `motion/humanml.py` (w-first quaternions, cont6d = matrix columns,
  `recover_root_rot_pos` / `recover_from_ric` / `recover_rot`, `Skeleton`
  FK / IK) at 1e-5 in float32 (the JAX package runs float32 here); the
  port's `recover_from_ric` over T = 196 in float32 stays within 1e-4 of its
  float64 result (the cumulative sums drift).
* `models/clip_text.py`: the encoder (width 32, 2 layers, 77 tokens) from the
  flax params at 1e-5, `hash_tokenize` exact, the OpenAI / HF converters.
* `models/mdm_text.py`: `TextMDM` forward with and without `uncond` and the
  train forward with dropout off (the condition drop injected) at 5e-4;
  `make_t2m_cond_builder` and the diffusion loss on the same t and noise
  at 1e-6.
* `data/humanml.py`: `Text2MotionDataset` batches for a seed equal the JAX
  package's exactly, train and evaluator batches both.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.data import humanml as jhd
from diffusestylegesture_tpu.models import clip_text as jclip
from diffusestylegesture_tpu.models import mdm_text as jmt
from diffusestylegesture_tpu.motion import humanml as jhm
from diffusestylegesture_tpu.utils import rotations as jrot
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.data import humanml as thd
from diffusestylegesture_torch.models import clip_text as tclip
from diffusestylegesture_torch.models import mdm_text as tmt
from diffusestylegesture_torch.models.convert import text_mdm_state_dict_from_flax
from diffusestylegesture_torch.motion import humanml as thm
from diffusestylegesture_torch.utils import rotations as trot

from torch_port_utils import np32, randomize_flax_params


def close(out, ref, atol):
    np.testing.assert_allclose(np32(out), np32(ref), rtol=0, atol=atol)


def unit_quats(rng, shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---- utils/rotations.py ---------------------------------------------------------

def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    q = unit_quats(rng, (5, 7))
    aa = (0.8 * rng.standard_normal((5, 7, 3))).astype(np.float32)
    aa[0, 0] = 0.0  # the small-angle branch
    d6 = rng.standard_normal((5, 7, 6)).astype(np.float32)
    eul = rng.standard_normal((5, 7, 3)).astype(np.float32)
    m = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q)))
    tq = torch.from_numpy
    pairs = [
        (trot.quaternion_to_matrix(tq(q)), jrot.quaternion_to_matrix(jnp.asarray(q))),
        (trot.matrix_to_quaternion(tq(m)), jrot.matrix_to_quaternion(jnp.asarray(m))),
        (trot.axis_angle_to_quaternion(tq(aa)), jrot.axis_angle_to_quaternion(jnp.asarray(aa))),
        (trot.quaternion_to_axis_angle(tq(q)), jrot.quaternion_to_axis_angle(jnp.asarray(q))),
        (trot.axis_angle_to_matrix(tq(aa)), jrot.axis_angle_to_matrix(jnp.asarray(aa))),
        (trot.matrix_to_axis_angle(tq(m)), jrot.matrix_to_axis_angle(jnp.asarray(m))),
        (trot.rotation_6d_to_matrix(tq(d6)), jrot.rotation_6d_to_matrix(jnp.asarray(d6))),
        (trot.matrix_to_rotation_6d(tq(m)), jrot.matrix_to_rotation_6d(jnp.asarray(m))),
        (trot.quaternion_multiply(tq(q), tq(q[::-1].copy())),
         jrot.quaternion_multiply(jnp.asarray(q), jnp.asarray(q[::-1]))),
        (trot.quaternion_invert(tq(q)), jrot.quaternion_invert(jnp.asarray(q))),
    ] + [(trot.euler_angles_to_matrix(tq(eul), c), jrot.euler_angles_to_matrix(jnp.asarray(eul), c))
         for c in ("XYZ", "ZYX", "YXZ")]
    for out, ref in pairs:
        close(out, ref, 1e-6)


# ---- motion/humanml.py ----------------------------------------------------------

def ric_features(T, joints=22, seed=0):
    """Seeded 263-d (22 joints) / 251-d (21 joints) RIC rows with smooth root motion."""
    rng = np.random.default_rng(seed)
    D = 4 + (joints - 1) * 9 + joints * 3 + 4
    data = (0.3 * rng.standard_normal((T, D))).astype(np.float32)
    data[:, 0] = 0.05 * np.sin(np.arange(T) / 7.0)  # root yaw velocity
    data[:, 3] = 0.9 + 0.02 * rng.standard_normal(T)  # root height
    return data


def test_humanml_quaternions_and_cont6d_match_jax():
    rng = np.random.default_rng(1)
    q, r = unit_quats(rng, (6, 5)), unit_quats(rng, (6, 5))
    v = rng.standard_normal((6, 5, 3)).astype(np.float32)
    u = rng.standard_normal((6, 5, 3)).astype(np.float32)
    c6 = rng.standard_normal((6, 5, 6)).astype(np.float32)
    tq = torch.from_numpy
    close(thm.qinv(tq(q)), jhm.qinv(jnp.asarray(q)), 1e-6)
    close(thm.qmul(tq(q), tq(r)), jhm.qmul(jnp.asarray(q), jnp.asarray(r)), 1e-6)
    close(thm.qrot(tq(q), tq(v)), jhm.qrot(jnp.asarray(q), jnp.asarray(v)), 1e-5)
    close(thm.qrot(tq(q[:, :1]), tq(v)), jhm.qrot(jnp.asarray(q[:, :1]), jnp.asarray(v)), 1e-5)
    close(thm.qbetween(tq(u), tq(v)), jhm.qbetween(jnp.asarray(u), jnp.asarray(v)), 1e-5)
    close(thm.quaternion_to_cont6d(tq(q)), jhm.quaternion_to_cont6d(jnp.asarray(q)), 1e-6)
    close(thm.cont6d_to_matrix(tq(c6)), jhm.cont6d_to_matrix(jnp.asarray(c6)), 1e-5)
    # the two 6D conventions differ: humanml takes columns, pytorch3d rows
    m = thm.quaternion_to_matrix(tq(q))
    assert torch.allclose(thm.quaternion_to_cont6d(tq(q)),
                          trot.matrix_to_rotation_6d(m.transpose(-1, -2)), atol=1e-6)
    assert not torch.allclose(thm.quaternion_to_cont6d(tq(q)), trot.matrix_to_rotation_6d(m),
                              atol=1e-3)


@pytest.mark.parametrize("joints", [22, 21], ids=["humanml", "kit"])
def test_humanml_recovery_matches_jax(joints):
    data = ric_features(60, joints)
    batch = np.stack([data, ric_features(60, joints, seed=5)])
    for fn in ("recover_root_rot_pos", "recover_rot"):
        out = getattr(thm, fn)(torch.from_numpy(batch))
        ref = getattr(jhm, fn)(jnp.asarray(batch))
        for o, r in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            close(o, r, 1e-5)
    close(thm.recover_from_ric(torch.from_numpy(batch), joints),
          jax.jit(jhm.recover_from_ric, static_argnums=1)(jnp.asarray(batch), joints), 1e-5)


def test_recover_from_ric_float32_drift_at_196_frames():
    data = ric_features(196)
    ref = jax.jit(jhm.recover_from_ric, static_argnums=1)(jnp.asarray(data), 22)
    out32 = thm.recover_from_ric(torch.from_numpy(data), 22)
    close(out32, ref, 1e-5)
    out64 = thm.recover_from_ric(torch.from_numpy(data).double(), 22)
    assert out64.dtype == torch.float64
    assert (out32.double() - out64).abs().max().item() < 1e-4


def test_skeleton_fk_ik_match_jax():
    rng = np.random.default_rng(2)
    joints = rng.standard_normal((22, 3)).astype(np.float32)
    tskel = thm.Skeleton(thm.t2m_raw_offsets, thm.t2m_kinematic_chain)
    jskel = jhm.Skeleton(jhm.t2m_raw_offsets, jhm.t2m_kinematic_chain)
    assert tskel.parents == jskel.parents
    close(tskel.get_offsets_joints(torch.from_numpy(joints)),
          jskel.get_offsets_joints(jnp.asarray(joints)), 1e-5)
    pose = rng.standard_normal((8, 22, 3)).astype(np.float32)
    face = [2, 1, 17, 16]
    tq = tskel.inverse_kinematics(torch.from_numpy(pose), face)
    jq = jskel.inverse_kinematics(jnp.asarray(pose), face)
    close(tq, jq, 1e-5)
    root = rng.standard_normal((8, 3)).astype(np.float32)
    close(tskel.forward_kinematics(tq, torch.from_numpy(root)),
          jskel.forward_kinematics(jq, jnp.asarray(root)), 1e-5)
    c6 = rng.standard_normal((8, 22, 6)).astype(np.float32)
    close(tskel.forward_kinematics_cont6d(torch.from_numpy(c6), torch.from_numpy(root)),
          jskel.forward_kinematics_cont6d(jnp.asarray(c6), jnp.asarray(root)), 1e-5)
    # per-frame bone lengths (skel_joints of rank 3) and recover_from_rot
    close(tskel.forward_kinematics(tq, torch.from_numpy(root),
                                   skel_joints=torch.from_numpy(pose)),
          jskel.forward_kinematics(jq, jnp.asarray(root), skel_joints=jnp.asarray(pose)), 1e-5)
    data = ric_features(8)
    close(thm.recover_from_rot(torch.from_numpy(data), 22, tskel),
          jhm.recover_from_rot(jnp.asarray(data), 22, jskel), 1e-5)
    for name in ("HML_ROOT_MASK", "HML_LOWER_BODY_MASK", "HML_UPPER_BODY_MASK"):
        assert np.array_equal(getattr(thm, name), getattr(jhm, name))


# ---- models/clip_text.py --------------------------------------------------------

CLIP_KW = dict(vocab_size=49408, width=32, layers=2, heads=4, context_length=77,
               projection_dim=24)
CAPTIONS = ["a person walks forward, then turns.", "someone waves with the left hand",
            " ".join(["jump"] * 90)]


def flax_clip(seed=0):
    cfg = jclip.ClipTextConfig(**CLIP_KW)
    params = jax.jit(jclip.ClipTextEncoder(cfg).init)(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 77), jnp.int32))["params"]
    return cfg, randomize_flax_params(params, seed)


def test_hash_tokenize_is_exact():
    for ctx in (77, 8):
        assert np.array_equal(tclip.hash_tokenize(CAPTIONS, ctx),
                              jclip.hash_tokenize(CAPTIONS, ctx))


def test_clip_text_encoder_matches_flax():
    cfg, params = flax_clip()
    ids = jclip.hash_tokenize(CAPTIONS)
    ref = jax.jit(jclip.ClipTextEncoder(cfg).apply)({"params": params}, jnp.asarray(ids))
    enc = tclip.ClipTextEncoder(tclip.ClipTextConfig(**CLIP_KW)).eval()
    enc.load_state_dict(tclip.clip_state_dict_from_flax(params))
    with torch.no_grad():
        out = enc(torch.from_numpy(ids))
    close(out, ref, 1e-5)


def test_clip_converters_and_caption_encoder(tmp_path):
    """The OpenAI and HF state-dict layouts, built from the port's weights,
    convert back to them; the npz of the JAX package's `save_params_npz`
    serves through `make_caption_encoder` as the flax encoder does."""
    from diffusestylegesture_tpu.train.checkpoint import save_params_npz

    cfg, params = flax_clip(1)
    sd = tclip.clip_state_dict_from_flax(params)
    hf, oa = {}, {}
    hf["text_model.embeddings.token_embedding.weight"] = sd["token_embedding"]
    hf["text_model.embeddings.position_embedding.weight"] = sd["position_embedding"]
    hf["text_projection.weight"] = sd["text_projection.weight"]
    oa["token_embedding.weight"] = sd["token_embedding"]
    oa["positional_embedding"] = sd["position_embedding"]
    oa["text_projection"] = sd["text_projection.weight"].T
    for a, b in (("weight", "weight"), ("bias", "bias")):
        hf[f"text_model.final_layer_norm.{a}"] = sd[f"ln_final.{b}"]
        oa[f"ln_final.{a}"] = sd[f"ln_final.{b}"]
    for i in range(2):
        bp = f"blocks.{i}"
        hp, op = f"text_model.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for p in ("weight", "bias"):
            hf[f"{hp}.layer_norm1.{p}"] = oa[f"{op}.ln_1.{p}"] = sd[f"{bp}.ln_1.{p}"]
            hf[f"{hp}.layer_norm2.{p}"] = oa[f"{op}.ln_2.{p}"] = sd[f"{bp}.ln_2.{p}"]
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                hf[f"{hp}.self_attn.{n}.{p}"] = sd[f"{bp}.attn.{n}.{p}"]
            hf[f"{hp}.mlp.fc1.{p}"] = oa[f"{op}.mlp.c_fc.{p}"] = sd[f"{bp}.mlp_fc1.{p}"]
            hf[f"{hp}.mlp.fc2.{p}"] = oa[f"{op}.mlp.c_proj.{p}"] = sd[f"{bp}.mlp_fc2.{p}"]
            oa[f"{op}.attn.out_proj.{p}"] = sd[f"{bp}.attn.out_proj.{p}"]
        oa[f"{op}.attn.in_proj_weight"] = torch.cat(
            [sd[f"{bp}.attn.{n}.weight"] for n in ("q_proj", "k_proj", "v_proj")])
        oa[f"{op}.attn.in_proj_bias"] = torch.cat(
            [sd[f"{bp}.attn.{n}.bias"] for n in ("q_proj", "k_proj", "v_proj")])
    for conv in (tclip.convert_hf_clip_text(hf, 2), tclip.convert_openai_clip_text(oa, 2)):
        assert conv.keys() == sd.keys()
        assert all(torch.equal(conv[k], sd[k]) for k in sd)

    path = str(tmp_path / "clip.npz")
    save_params_npz(path, params)
    encode, spec = tclip.make_caption_encoder(path, **CLIP_KW, device="cpu")
    assert spec["params_path"] == path and spec["width"] == 32
    ref = jax.jit(jclip.ClipTextEncoder(cfg).apply)({"params": params},
                                                    jnp.asarray(jclip.hash_tokenize(CAPTIONS[:2])))
    close(encode(CAPTIONS[:2]), ref, 1e-5)
    with pytest.raises(tclip.SeedOnlyEncoderError, match="convert_orbax_to_torch"):
        tclip.caption_encoder_from_spec({"params_path": None, "seed": 0, **CLIP_KW}, "",
                                        device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            tclip.make_caption_encoder(path, **CLIP_KW)
        else:
            raise RuntimeError("device='cpu'")


# ---- models/mdm_text.py ---------------------------------------------------------

B, NJ, T = 3, 20, 15
MDM_KW = dict(njoints=NJ, latent_dim=64, ff_size=96, num_layers=2, num_heads=4, clip_dim=24)


def mdm_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    t = np.array([999, 3, 500], np.int64)
    emb = rng.standard_normal((B, 24)).astype(np.float32)
    return x, t, emb


def mdm_pair(cond_mask_prob=0.1, dropout=0.1, impl="kernel"):
    fmodel = jmt.TextMDM(jmt.TextMDMConfig(**MDM_KW, cond_mask_prob=cond_mask_prob,
                                           dropout=dropout))
    x, t, emb = mdm_inputs()
    params = jax.jit(fmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                  {"text_emb": jnp.asarray(emb)})
    params = {"params": randomize_flax_params(params["params"], 0)}
    model = tmt.TextMDM(tmt.TextMDMConfig(**MDM_KW, cond_mask_prob=cond_mask_prob,
                                          dropout=dropout, impl=impl)).eval()
    model.load_state_dict(text_mdm_state_dict_from_flax(params))
    return fmodel, params, model


@pytest.mark.parametrize("uncond", [None, [False, True, False]], ids=["cond", "cfg_mixed"])
def test_text_mdm_forward_matches_flax(uncond):
    fmodel, params, model = mdm_pair()
    x, t, emb = mdm_inputs(1)
    ju = None if uncond is None else jnp.asarray(uncond)
    ref = jax.jit(fmodel.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                {"text_emb": jnp.asarray(emb)}, uncond=ju)
    tu = None if uncond is None else torch.tensor(uncond)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), {"text_emb": torch.from_numpy(emb)},
                    uncond=tu)
    assert out.shape == (B, NJ, 1, T)
    close(out, ref, 5e-4)


def test_text_mdm_train_forward_matches_flax():
    """Dropout off: the JAX train forward without a condition drop equals the
    port's; a drop the port is handed (`cond_drop`) equals the JAX forward
    with those rows unconditioned."""
    fmodel, params, _ = mdm_pair(cond_mask_prob=0.0, dropout=0.0)
    _, _, model = mdm_pair(cond_mask_prob=0.0, dropout=0.0, impl="plain")
    x, t, emb = mdm_inputs(2)
    jin = (jnp.asarray(x), jnp.asarray(t), {"text_emb": jnp.asarray(emb)})
    tin = (torch.from_numpy(x), torch.from_numpy(t), {"text_emb": torch.from_numpy(emb)})
    ref = jax.jit(lambda p, *a: fmodel.apply(p, *a, train=True))(params, *jin)
    drop = np.array([True, False, True])
    ref_drop = jax.jit(fmodel.apply)(params, *jin, uncond=jnp.asarray(drop))
    with torch.no_grad():
        close(model(*tin, train=True), ref, 5e-4)
        close(model(*tin, train=True, cond_drop=torch.from_numpy(drop)), ref_drop, 5e-4)
    with pytest.raises(ValueError, match="impl='plain'"):
        mdm_pair()[2](*tin, train=True)


def test_t2m_cond_builder_and_loss_match_jax():
    fmodel, params, model = mdm_pair(cond_mask_prob=0.0, dropout=0.0, impl="plain")
    rng = np.random.default_rng(3)
    batch = {"motion": rng.standard_normal((B, T, NJ)).astype(np.float32),
             "text_emb": rng.standard_normal((B, 24)).astype(np.float32),
             "lengths": np.array([15, 7, 12], np.int32)}
    jx, jc, jm = jmt.make_t2m_cond_builder()({k: jnp.asarray(v) for k, v in batch.items()})
    tx, tc, tm = tmt.make_t2m_cond_builder()({k: torch.from_numpy(v) for k, v in batch.items()})
    for o, r in ((tx, jx), (tc["text_emb"], jc["text_emb"]), (tm, jm)):
        assert tuple(o.shape) == tuple(r.shape)
        assert np.array_equal(np32(o), np32(r))
    betas = JD.named_beta_schedule("cosine", 20)
    t = rng.integers(0, 20, B)
    noise = rng.standard_normal(tx.shape).astype(np.float32)
    jterms, _ = JD.training_losses(
        JD.Schedule.create(betas), lambda x, tt: fmodel.apply(params, x, tt, jc), jx,
        jnp.asarray(t), jnp.asarray(noise), jm)
    with torch.no_grad():
        tterms, _ = TD.training_losses(
            TD.Schedule.create(betas, device="cpu"), lambda x, tt: model(x, tt, tc), tx,
            torch.from_numpy(t), torch.from_numpy(noise), tm)
    close(tterms["loss"], jterms["loss"], 1e-6)


# ---- data/humanml.py ------------------------------------------------------------

def write_corpus(root, n=10, nj=263, seed=0):
    """A seeded HumanML3D-format corpus: joint vecs, `caption#tokens#f#t`
    captions (with a sub-clip and a malformed line), a split file, a GloVe
    table."""
    rng = np.random.default_rng(seed)
    mdir, tdir, gdir = (os.path.join(root, d) for d in ("joint_vecs", "texts", "glove"))
    for d in (mdir, tdir, gdir):
        os.makedirs(d, exist_ok=True)
    ids = []
    for i in range(n):
        name = f"{i:06d}"
        ids.append(name)
        np.save(os.path.join(mdir, f"{name}.npy"),
                rng.standard_normal((int(rng.integers(40, 120)), nj)).astype(np.float32))
        lines = ["a person walks slowly#a/DET person/NOUN walk/VERB slowly/ADV#0.0#0.0",
                 f"someone waves {i}#someone/PRON wave/VERB#0.0#0.0"]
        if i % 3 == 0:
            lines.append("a man runs#a/DET man/NOUN run/VERB#0.0#2.5")
        if i % 4 == 0:
            lines.append("broken#line#x#y")
        with open(os.path.join(tdir, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(ids + ["missing"]))
    words = ["unk", "sos", "eos", "a", "person", "walk", "slowly", "someone", "wave", "man"]
    np.save(os.path.join(gdir, "our_vab_data.npy"),
            rng.standard_normal((len(words), 300)).astype(np.float32))
    with open(os.path.join(gdir, "our_vab_words.pkl"), "wb") as f:
        pickle.dump(words, f)
    with open(os.path.join(gdir, "our_vab_idx.pkl"), "wb") as f:
        pickle.dump({w: i for i, w in enumerate(words)}, f)
    return mdir, tdir, gdir, os.path.join(root, "train.txt")


def test_text2motion_dataset_batches_equal_jax(tmp_path):
    mdir, tdir, gdir, split = write_corpus(str(tmp_path))
    mean, std = np.zeros(263, np.float32), np.ones(263, np.float32)
    sets = []
    for hd in (jhd, thd):
        wv = hd.WordVectorizer(gdir, "our_vab")
        cfg = hd.T2MConfig(motion_dir=mdir, text_dir=tdir, max_motion_length=120)
        sets.append((hd.Text2MotionDataset(cfg, mean, std, split, wv, seed=4),
                     hd.Text2MotionDataset(cfg, mean, std, split, None, seed=4)))
    (jeval, jtrain), (teval, ttrain) = sets
    assert jeval.name_list == teval.name_list and len(jeval) == len(teval) > 0
    assert jtrain.captions() == ttrain.captions()
    for jb, tb in zip(jeval.batches(4), teval.batches(4)):
        assert jb.keys() == tb.keys()
        for k in jb:
            assert np.array_equal(np.asarray(jb[k]), np.asarray(tb[k])), k
    embs = {c: np.full(8, i, np.float32) for i, c in enumerate(jtrain.captions())}
    jit, tit = jtrain.train_batches(3, embs), ttrain.train_batches(3, embs)
    for _ in range(5):
        jb, tb = next(jit), next(tit)
        for k in jb:
            assert np.array_equal(jb[k], tb[k]), k
    rows = [teval[i] for i in range(3)]
    jrows = [jeval[i] for i in range(3)]
    jm, jcond = jhd.t2m_collate(jrows)
    tm, tcond = thd.t2m_collate(rows)
    assert np.array_equal(jm, tm)
    assert np.array_equal(jcond["y"]["mask"], tcond["y"]["mask"])
    assert np.array_equal(thd.lengths_to_mask(np.array([2, 5]), 6),
                          jhd.lengths_to_mask(np.array([2, 5]), 6))
