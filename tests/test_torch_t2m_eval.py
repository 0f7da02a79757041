"""Evaluation modules of the text-to-motion slice vs the JAX package.

* `eval/t2m.py`: `top_k_hits` (with distance ties) exact, R-precision and
  matching score at 1e-8.
* `eval/t2m_evaluator.py`: the three encoders from the JAX params
  (`evaluator_state_dicts_from_flax`, the `finest.tar` layout) on unsorted
  lengths at 1e-5, outputs in input order; the harness on fixed embeddings
  at 1e-6 (the same numpy draws).
* `eval/stgcn.py`: `Graph` adjacencies exact, `STGCN` (features and logits,
  the JAX layout in and out) at 1e-5, the accuracy and the MT19937 draw
  sequence of `calculate_diversity_multimodality` exact.
* `eval/action2motion.py`: `MotionDiscriminator` logits and `for_fid`
  features at 1e-5 on unsorted lengths.
* `models/smpl.py`: `lbs`, `SmplJoints` and `Rotation2xyz` (every rotation
  representation, masked frames, translation) over a seeded synthetic SMPL
  (6,890 vertices, 24 joints, 10 betas) at 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu.eval import action2motion as ja2m
from diffusestylegesture_tpu.eval import stgcn as jst
from diffusestylegesture_tpu.eval import t2m as jt2m
from diffusestylegesture_tpu.eval import t2m_evaluator as jev
from diffusestylegesture_tpu.models import smpl as jsmpl
from diffusestylegesture_torch.eval import action2motion as ta2m
from diffusestylegesture_torch.eval import stgcn as tst
from diffusestylegesture_torch.eval import t2m as tt2m
from diffusestylegesture_torch.eval import t2m_evaluator as tev
from diffusestylegesture_torch.models import smpl as tsmpl

from torch_port_utils import np32, randomize_flax_params


def close(out, ref, atol):
    np.testing.assert_allclose(np32(out), np32(ref), rtol=0, atol=atol)


def test_t2m_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 8))
    b = a + 0.3 * rng.standard_normal((12, 8))
    b[5] = b[4]  # a tie in the distance matrix
    ties = np.argsort(np.round(tt2m.euclidean_distance_matrix(a, b), 1), axis=1, kind="stable")
    assert np.array_equal(tt2m.top_k_hits(ties, 3), jt2m.top_k_hits(ties, 3))
    for sum_all in (False, True):
        assert np.array_equal(tt2m.r_precision(a, b, 3, sum_all), jt2m.r_precision(a, b, 3, sum_all))
        np.testing.assert_allclose(tt2m.matching_score(a, b, sum_all),
                                   jt2m.matching_score(a, b, sum_all), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tt2m.euclidean_distance_matrix(a, b),
                               jt2m.euclidean_distance_matrix(a, b), rtol=0, atol=1e-8)


# ---- the T2M evaluator ---------------------------------------------------------------

@pytest.fixture(scope="module")
def evaluators():
    params = jax.jit(jev.T2MEvaluator.init_params)(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, randomize_flax_params(params, 3))
    for name in ("text", "motion"):  # the GRUs' initial states at a moderate scale
        params[name]["hidden"] = 0.3 * params[name]["hidden"]
    jw = jev.T2MEvaluator(params)
    tw = tev.T2MEvaluator(tev.evaluator_state_dicts_from_flax(params), device="cpu")
    return jw, tw


def eval_batch(seed, B=5, T=40):
    rng = np.random.default_rng(seed)
    return {"word_embs": rng.standard_normal((B, 22, 300)).astype(np.float32),
            "pos_ohot": np.eye(15, dtype=np.float32)[rng.integers(0, 15, (B, 22))],
            "cap_lens": np.array([7, 22, 3, 15, 9][:B]),
            "motions": rng.standard_normal((B, T, 263)).astype(np.float32),
            "m_lens": np.array([24, 40, 8, 36, 16][:B])}


def test_t2m_evaluator_encoders_match_jax_in_input_order(evaluators):
    jw, tw = evaluators
    b = eval_batch(1)
    jt, jm = jw.get_co_embeddings(b["word_embs"], b["pos_ohot"], b["cap_lens"], b["motions"],
                                  b["m_lens"])
    tt, tm = tw.get_co_embeddings(b["word_embs"], b["pos_ohot"], b["cap_lens"], b["motions"],
                                  b["m_lens"])
    close(tt, jt, 1e-5)
    close(tm, jm, 1e-5)
    # input order: a row's embedding does not depend on where it stands
    perm = np.array([3, 0, 4, 1, 2])
    pt, _ = tw.get_co_embeddings(*(b[k][perm] for k in ("word_embs", "pos_ohot", "cap_lens")),
                                 b["motions"][perm], b["m_lens"][perm])
    close(pt, tt[perm], 1e-6)


def test_t2m_evaluation_harness_matches_jax(evaluators):
    jw, tw = evaluators
    batches = [eval_batch(s) for s in (2, 3)]
    gen = [eval_batch(s) for s in (4, 5)]
    out = {}
    for mod, w in ((jev, jw), (tev, tw)):
        out[mod] = mod.evaluation(w, lambda: iter(batches), {"gen": lambda: iter(gen)},
                                  replication_times=2, diversity_times=4, mm_num_times=2,
                                  mm_loader_fns={"gen": lambda: iter(gen)})
    for metric, models in out[jev].items():
        for name, (mean, ci) in models.items():
            tmean, tci = out[tev][metric][name]
            np.testing.assert_allclose(tmean, mean, rtol=1e-4, atol=1e-4, err_msg=metric)
            np.testing.assert_allclose(tci, ci, rtol=1e-4, atol=1e-4, err_msg=metric)
    # on fixed embeddings the harness's numpy part agrees to 1e-6
    rng = np.random.default_rng(6)
    acts = {"gen": rng.standard_normal((20, 16)), "gt": rng.standard_normal((20, 16))}
    for seed in (0, 1):
        j = jev.evaluate_diversity(acts, 6, seed)
        t = tev.evaluate_diversity(acts, 6, seed)
        assert j.keys() == t.keys()
        np.testing.assert_allclose(list(t.values()), list(j.values()), rtol=0, atol=1e-6)
    stats = rng.standard_normal((4, 3))
    for a, b in zip(tev.get_metric_statistics(stats, 4), jev.get_metric_statistics(stats, 4)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# ---- ST-GCN and the motion discriminator -----------------------------------------------

@pytest.mark.parametrize("layout,strategy", [("smpl", "spatial"), ("openpose", "uniform"),
                                             ("ntu-rgb+d", "distance"),
                                             ("smpl_noglobal", "spatial"),
                                             ("openpose15", "spatial")])
def test_graph_adjacency_equals_jax(layout, strategy):
    assert np.array_equal(tst.Graph(layout, strategy, max_hop=2).A,
                          jst.Graph(layout, strategy, max_hop=2).A)


def test_stgcn_matches_jax_and_metrics_draw_the_same():
    net = jst.STGCN(6, 12, jst.Graph(layout="smpl", strategy="spatial"))
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 24, 6, 8)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = randomize_flax_params(variables["params"], 1)
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map(
        lambda a: (1.0 + 0.2 * rng.random(a.shape)).astype(np.float32), variables["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    motion = rng.standard_normal((3, 24, 6, 20)).astype(np.float32)
    jev_ = jst.A2MEvaluation(variables, 6, 12, seed=5)
    tev_ = tst.A2MEvaluation(tst.stgcn_state_dict_from_flax(variables), 6, 12, seed=5,
                             device="cpu")
    jf, jl = jax.jit(jev_.model.apply)(variables, jnp.asarray(motion))
    with torch.no_grad():
        tf, tl = tev_.model(torch.from_numpy(motion))
    close(tf, jf, 1e-5)
    close(tl, jl, 1e-5)
    feats = rng.standard_normal((40, 8))
    labels = rng.integers(0, 4, 40)
    for seed in (0, 7):
        assert tst.calculate_diversity_multimodality(feats, labels, 4, seed=seed) == \
            jst.calculate_diversity_multimodality(feats, labels, 4, seed=seed)
    acc, conf = tst.calculate_accuracy(feats[:, :4], labels, 4)
    jacc, jconf = jst.calculate_accuracy(feats[:, :4], labels, 4)
    assert acc == jacc and np.array_equal(conf, jconf)
    loaders = {"gt": [{"output": motion, "y": np.array([0, 1, 2])}] * 3,
               "gen": [{"output": motion[::-1].copy(), "y": np.array([2, 1, 0])}] * 3}
    jm, tm = jev_.evaluate(loaders), tev_.evaluate(loaders)
    assert jm.keys() == tm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("for_fid", [False, True], ids=["logits", "for_fid"])
def test_motion_discriminator_matches_jax(for_fid):
    B, J, F, T = 4, 24, 3, 30
    jm = ja2m.MotionDiscriminator(for_fid=for_fid)
    rng = np.random.default_rng(3)
    motion = rng.standard_normal((B, J, F, T)).astype(np.float32)
    lengths = np.array([30, 5, 17, 22])
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(motion),
                              jnp.asarray(lengths))["params"]
    params = randomize_flax_params(params, 4)
    if for_fid:
        params = {**params, "linear2": {"kernel": np.zeros((30, 12), np.float32),
                                        "bias": np.zeros(12, np.float32)}}
    tm = ta2m.MotionDiscriminator(J * F, for_fid=for_fid)
    sd = ta2m.motion_discriminator_state_dict_from_flax(params)
    if for_fid:
        sd = {k: v for k, v in sd.items() if not k.startswith("linear2")}
    tm.load_state_dict(sd)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(motion), jnp.asarray(lengths))
    with torch.no_grad():
        out = tm(torch.from_numpy(motion), torch.from_numpy(lengths))
    close(out, ref, 1e-5)
    feats = rng.standard_normal((30, 6))
    t = ta2m.unconstrained_metrics(feats, feats + 0.1, diversity_times=10, kid_subsets=3)
    j = ja2m.unconstrained_metrics(feats, feats + 0.1, diversity_times=10, kid_subsets=3)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-8, err_msg=k)


# ---- SMPL ----------------------------------------------------------------------------

def synthetic_smpl_arrays(seed=0, V=6890, J=24, nb=10, extra=True):
    """Seeded SMPL-shaped arrays: a body-sized template, small blend shapes,
    row-normalised regressors and skinning weights."""
    rng = np.random.default_rng(seed)
    arrays = {"v_template": (0.5 * rng.standard_normal((V, 3))).astype(np.float32),
              "shapedirs": (0.01 * rng.standard_normal((V, 3, nb))).astype(np.float32),
              "posedirs": (0.001 * rng.standard_normal(((J - 1) * 9, V * 3))).astype(np.float32),
              "kintree_parents": np.asarray(jsmpl.SMPL_PARENTS, np.int64)}
    reg = rng.random((J, V)) ** 8
    arrays["J_regressor"] = (reg / reg.sum(1, keepdims=True)).astype(np.float32)
    w = rng.random((V, J)) ** 6
    arrays["weights"] = (w / w.sum(1, keepdims=True)).astype(np.float32)
    if extra:
        e = rng.random((9, V)) ** 8
        arrays["J_regressor_extra"] = (e / e.sum(1, keepdims=True)).astype(np.float32)
    return arrays


@pytest.fixture(scope="module")
def smpl_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smpl") / "smpl.npz")
    np.savez(path, **synthetic_smpl_arrays())
    return jsmpl.SmplModel.from_npz(path), tsmpl.SmplModel.from_npz(path, device="cpu")


def test_smpl_lbs_matches_jax(smpl_pair):
    jmodel, tmodel = smpl_pair
    rng = np.random.default_rng(5)
    betas = rng.standard_normal((3, 10)).astype(np.float32)
    aa = (0.4 * rng.standard_normal((3, 24, 3))).astype(np.float32)
    close(tsmpl.batch_rodrigues(torch.from_numpy(aa)), jsmpl.batch_rodrigues(jnp.asarray(aa)),
          1e-6)
    rotmats = np.asarray(jsmpl.batch_rodrigues(jnp.asarray(aa)))
    jv, jj = jsmpl.lbs(jmodel, jnp.asarray(betas), jnp.asarray(rotmats))
    tv, tj = tsmpl.lbs(tmodel, torch.from_numpy(betas), torch.from_numpy(rotmats))
    close(tv, jv, 1e-5)
    close(tj, jj, 1e-5)
    jo = jsmpl.SmplJoints(jmodel)(jnp.asarray(rotmats[:, 1:]), jnp.asarray(rotmats[:, 0]),
                                  jnp.asarray(betas))
    to = tsmpl.SmplJoints(tmodel)(torch.from_numpy(rotmats[:, 1:]),
                                  torch.from_numpy(rotmats[:, 0]), torch.from_numpy(betas))
    assert jo.keys() == to.keys()
    for k in jo:
        close(to[k], jo[k], 1e-5)


@pytest.mark.parametrize("pose_rep,feats", [("rot6d", 6), ("rotvec", 3), ("rotquat", 4),
                                            ("rotmat", 9)])
def test_rotation2xyz_matches_jax(smpl_pair, pose_rep, feats):
    jmodel, tmodel = smpl_pair
    rng = np.random.default_rng(6)
    B, T = 2, 5
    x = (0.5 * rng.standard_normal((B, 25, feats, T))).astype(np.float32)
    if pose_rep == "rotmat":
        x[:, :24] = np.asarray(jsmpl.batch_rodrigues(jnp.asarray(
            x[:, :24, :3].transpose(0, 1, 3, 2)))).reshape(B, 24, T, 9).transpose(0, 1, 3, 2)
    mask = np.ones((B, T), bool)
    mask[1, 3:] = False
    j2x, t2x = jsmpl.Rotation2xyz(jsmpl.SmplJoints(jmodel)), \
        tsmpl.Rotation2xyz(tsmpl.SmplJoints(tmodel))
    for jointstype in ("smpl", "a2m", "vertices"):
        kw = dict(pose_rep=pose_rep, translation=True, glob=True, jointstype=jointstype,
                  vertstrans=jointstype == "vertices", beta=0.3)
        ref = j2x(jnp.asarray(x), jnp.asarray(mask), **kw)
        out = t2x(torch.from_numpy(x), torch.from_numpy(mask), **kw)
        close(out, ref, 1e-5)
    kw = dict(pose_rep=pose_rep, translation=False, glob=False, jointstype="smpl",
              vertstrans=False, glob_rot=[np.pi, 0.0, 0.0])
    body = np.ascontiguousarray(x[:, 1:24])  # 23 body joints, the orientation given
    close(t2x(torch.from_numpy(body), None, **kw), j2x(jnp.asarray(body), None, **kw), 1e-5)


def test_smpl_pkl_converter_names_chumpy(tmp_path):
    try:
        import chumpy  # noqa: F401
        pytest.skip("chumpy is installed here")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="chumpy"):
        tsmpl.smpl_pkl_to_npz(str(tmp_path / "SMPL_NEUTRAL.pkl"), str(tmp_path / "out.npz"))
