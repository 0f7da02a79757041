"""Progressive distillation in the PyTorch port vs the JAX package, on the CPU.

At a small size (njoints 16, latent 96, 2 layers, T 22, a 40-step cosine base
respaced to 20 for the teacher), from converted weights and inputs made with
numpy:

* `student_schedule` equals JAX's in float64 to 1e-12 (every table, and the
  grid exactly) for an unspaced 1000-step teacher and down a chain of
  respaced teachers with `base_betas`.
* `ddim_step` and `two_step_target` agree at 1e-5 (rtol and atol).
* Three distillation steps with t and noise injected: the JAX reference is
  the body of its `loss_fn` (`train/distill.py:120-140`) reassembled from the
  JAX package's `q_sample`, `two_step_target` and `optax.adam`; each loss at
  1e-6 relative, the student's parameters at 1e-5, except entries whose
  gradient lies at the float32 noise floor (below 1e-5 of its tensor's RMS),
  held to Adam's own bound of lr a step, as in `test_torch_train_step.py`.
* The step's own draws put t only on the teacher's odd indices.
* `cli/distill.py --device cpu` end to end: two stages from a `cli/train.py`
  checkpoint, each stage dir's `schedule.json` equal to what the JAX CLI
  writes for the same config (built from the JAX package's
  `student_schedule`, not by running its CLI in this process, which would
  switch on JAX's persistent compilation cache for later tests), and served
  by `cli/sample.py --device cpu`.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.diffusion import gaussian as JG
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.train import distill as JDist
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.models.convert import mdm_state_dict_from_flax
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.train import TrainConfig, TrainState
from diffusestylegesture_torch.train import distill as TDist

from test_torch_train_loop import prepared  # noqa: F401  (a fixture)
from test_torch_train_step import assert_named_close, noise_floor_entries
from torch_port_utils import np32, randomize_flax_params

B, NJ, T, NSEED = 4, 16, 22, 4
KW = dict(njoints=NJ, latent_dim=96, ff_size=64, num_layers=2, window_size=11, n_seed=NSEED)
BASE = JD.named_beta_schedule("cosine", 40)
# the teacher: a respaced schedule, so the networks see timestep_map[t] ≠ t
JSCHED = JDist.student_schedule(JD.Schedule.create(BASE))
TSCHED = TDist.student_schedule(TD.Schedule.create(BASE, device="cpu"))
NT = JSCHED.num_timesteps
TOL = dict(rtol=1e-5, atol=1e-5)
SCHEDULE_FIELDS = [f.name for f in dataclasses.fields(TD.Schedule)]


def inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, NJ, 1, T)).astype(np.float32)
    cond = {"style": np.eye(6, dtype=np.float32)[rng.integers(0, 6, B)],
            "seed": rng.standard_normal((B, NJ, 1, NSEED)).astype(np.float32),
            "audio": rng.standard_normal((B, T, 1024)).astype(np.float32),
            "mask_local": np.ones((B, T), bool)}
    return x0, cond


def make_models(seed=0, impl="kernel"):
    """(flax model, randomized flax params, the port's MDM with those weights)."""
    fmodel = FlaxMDM(FlaxMDMConfig(**KW))
    x0, cond = inputs(0)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x0), jnp.zeros((B,), jnp.int32),
                         {k: jnp.asarray(v) for k, v in cond.items()})
    params = {"params": randomize_flax_params(params["params"], seed)}
    model = MDM(MDMConfig(**KW, impl=impl)).eval()
    model.load_state_dict(mdm_state_dict_from_flax(params))
    return fmodel, params, model


def assert_schedules_equal(port, ref):
    assert np.array_equal(port.timestep_map.numpy(), np.asarray(ref.timestep_map))
    for name in SCHEDULE_FIELDS:
        np.testing.assert_allclose(getattr(port, name).numpy().astype(np.float64),
                                   np.asarray(getattr(ref, name), np.float64),
                                   rtol=0, atol=1e-12, err_msg=name)


def test_student_schedule_of_an_unspaced_teacher_matches_jax():
    betas = JD.named_beta_schedule("cosine", 1000)
    port = TDist.student_schedule(TD.Schedule.create(betas, device="cpu"))
    assert_schedules_equal(port, JDist.student_schedule(JD.Schedule.create(betas)))
    assert port.num_timesteps == 500 and port.timestep_map[0] == 1


def test_student_schedule_down_a_respaced_chain_matches_jax():
    betas = JD.named_beta_schedule("cosine", 1000)
    jt, tt = JD.Schedule.create(betas), TD.Schedule.create(betas, device="cpu")
    for n in (500, 250, 125, 62):
        jt = JDist.student_schedule(jt, base_betas=betas)
        tt = TDist.student_schedule(tt, base_betas=betas)
        assert tt.num_timesteps == n
        assert_schedules_equal(tt, jt)
    with pytest.raises(ValueError, match="base_betas"):
        TDist.student_schedule(tt)


def test_ddim_step_and_two_step_target_match_jax():
    fmodel, params, model = make_models()
    x0, cond = inputs(1)
    t = np.array([1, 3, 11, NT - 1])
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    pred = np.random.default_rng(2).standard_normal(x0.shape).astype(np.float32)
    np.testing.assert_allclose(
        np32(TDist.ddim_step(TSCHED, torch.from_numpy(x0), torch.from_numpy(t),
                             torch.from_numpy(pred))),
        np.asarray(JDist.ddim_step(JSCHED, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(pred))),
        **TOL)
    jx0, jx2 = JDist.two_step_target(JSCHED, lambda x, tt: fmodel.apply(params, x, tt, jcond),
                                     jnp.asarray(x0), jnp.asarray(t))
    with torch.no_grad():
        tx0, tx2 = TDist.two_step_target(TSCHED, lambda x, tt: model(x, tt, tcond),
                                         torch.from_numpy(x0), torch.from_numpy(t))
    np.testing.assert_allclose(np32(tx2), np.asarray(jx2), **TOL)
    np.testing.assert_allclose(np32(tx0), np.asarray(jx0), **TOL)


def jax_distill_loss(fmodel, teacher_params, sched):
    """The JAX step's loss body with t and the noise given."""

    def loss_fn(p, x0, t, noise, cond):
        x_t = JG.q_sample(sched, x0, t, noise)
        pred = fmodel.apply(p, x_t, sched.timestep_map[t], cond)
        target, _ = JDist.two_step_target(
            sched, lambda x, tt: fmodel.apply(teacher_params, x, tt, cond), x_t, t)
        target = jax.lax.stop_gradient(target)
        ab = JG._bcast(sched.alphas_cumprod, t, x0.ndim)
        w = jnp.maximum(1.0, ab / (1.0 - ab))
        return jnp.mean(w * (pred - target) ** 2)

    return loss_fn


def test_three_distillation_steps_match_jax():
    lr = 1e-3
    fmodel, params, teacher = make_models()
    _, _, student = make_models(impl="plain")
    loss_fn = jax.jit(jax.value_and_grad(jax_distill_loss(fmodel, params, JSCHED)))
    tx = optax.adam(lr)
    jparams, opt = params, tx.init(params)
    state = TrainState(student, TrainConfig(lr=lr))
    step = TDist.make_distill_step(teacher, TSCHED)
    rng = np.random.default_rng(5)
    noisy = {}
    for i in range(3):
        x0, cond = inputs(10 + i)
        t = 2 * rng.integers(0, NT // 2, B) + 1
        noise = rng.standard_normal(x0.shape).astype(np.float32)
        jloss, grads = loss_fn(jparams, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                               {k: jnp.asarray(v) for k, v in cond.items()})
        updates, opt = tx.update(grads, opt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        out = step(state, torch.from_numpy(x0), {k: torch.from_numpy(v) for k, v in cond.items()},
                   None, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        noise_floor_entries(state, noisy)
        np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")
        assert_named_close(state.params.to_dict(state.params.data),
                           mdm_state_dict_from_flax(jparams), f"step {i}", noisy,
                           lr * (i + 1), **TOL)
    assert int(state.optimizer.count) == 3
    # the teacher is frozen and untouched
    assert not any(p.requires_grad for p in teacher.parameters())
    assert_named_close(dict(teacher.named_parameters()), mdm_state_dict_from_flax(params),
                       rtol=0, atol=0)


def test_steps_draw_t_on_the_teachers_odd_indices(monkeypatch):
    seen = []
    real = TDist.G.q_sample

    def recording(sched, x0, t, noise):
        seen.append(t.clone())
        return real(sched, x0, t, noise)

    monkeypatch.setattr(TDist.G, "q_sample", recording)
    _, _, teacher = make_models()
    _, _, student = make_models(impl="plain")
    state = TrainState(student, TrainConfig(lr=1e-4))
    step = TDist.make_distill_step(teacher, TSCHED)
    gen = torch.Generator().manual_seed(0)
    x0, cond = inputs(3)
    for _ in range(8):
        out = step(state, torch.from_numpy(x0), {k: torch.from_numpy(v) for k, v in cond.items()},
                   gen)
        assert np.isfinite(float(out["loss"]))
    t = torch.cat(seen)
    assert (t % 2 == 1).all() and t.min() >= 1 and t.max() <= NT - 1
    assert len(set(t.tolist())) > 3


# ---- the CLI end to end -----------------------------------------------------------


@pytest.fixture(scope="module")
def teacher_run(prepared):  # noqa: F811
    """A `cli/train.py` checkpoint (2 steps) of the prepared tiny run, which also
    writes the window set's WavLM feature cache; a yaml with an 8-step base."""
    from diffusestylegesture_torch.cli import train as train_cli

    save_dir = str(prepared / "teacher")
    train_cli.main(["--config", str(prepared / "zeggs.yml"), "--device", "cpu", "--save_dir",
                    save_dir, "--num_steps", "2"])
    with open(prepared / "zeggs.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["diffusion_steps"] = 8
    path = str(prepared / "zeggs_distill.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return prepared, path, save_dir


def test_cli_distill_two_stages_then_sample(teacher_run, tmp_path):
    from diffusestylegesture_torch.cli import distill as distill_cli
    from diffusestylegesture_torch.cli import sample as sample_cli

    root, cfg_path, teacher = teacher_run
    out = distill_cli.main(["--config", cfg_path, "--teacher", teacher, "--save_dir",
                            str(tmp_path / "distilled"), "--stages", "2", "--steps_per_stage",
                            "3", "--chunk", "2", "--batch_size", "4", "--device", "cpu"])
    dirs = [s["dir"] for s in out["stages"]]
    assert [os.path.basename(d) for d in dirs] == ["stage0_steps4", "stage1_steps2"]
    # ⌈3 / 2⌉ chunks of 2 steps, one loss read a chunk
    assert all(s["steps"] == 4 and len(s["losses"]) == 2 for s in out["stages"])
    assert all(np.isfinite(s["losses"]).all() for s in out["stages"])

    # what the JAX CLI writes (`cli/distill.py:175-186`) for this config
    betas = JD.named_beta_schedule("cosine", 8)
    jsched = JD.Schedule.create(betas)
    for d in dirs:
        jsched = JDist.student_schedule(jsched, base_betas=betas)
        with open(os.path.join(d, "schedule.json")) as f:
            meta = json.load(f)
        assert meta == {"base_steps": 8, "noise_schedule": "cosine",
                        "use_timesteps": np.asarray(jsched.timestep_map).tolist()}
    sd, sched = distill_cli.load_distilled(dirs[1], device="cpu")
    assert sched.timestep_map.tolist() == [3, 7]
    assert set(sd) == set(MDM(MDMConfig(njoints=1141, latent_dim=96, ff_size=32, num_layers=1,
                                        audio_in_dim=32)).state_dict())

    for d, steps in zip(dirs, (4, 2)):
        res = sample_cli.main(["--config", cfg_path, "--model_path", d, "--audiowavlm_path",
                               str(root / "015_Happy_4_x_1_0.wav"), "--save_dir",
                               str(tmp_path / f"bvh{steps}"), "--device", "cpu"])
        assert len(res["paths"]) == 1 and os.path.getsize(res["paths"][0]) > 0
        assert res["poses"].shape == (1, 2 * 80 - 8, 1141) and np.isfinite(res["poses"]).all()


def test_cli_distill_refuses_cuda_without_a_card(teacher_run, monkeypatch, tmp_path):
    from diffusestylegesture_torch.cli import distill as distill_cli

    _, cfg_path, teacher = teacher_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        distill_cli.main(["--config", cfg_path, "--teacher", teacher, "--save_dir",
                          str(tmp_path / "d")])


def test_cli_distill_needs_audio_features(teacher_run, tmp_path):
    from diffusestylegesture_torch.cli import distill as distill_cli

    root, cfg_path, teacher = teacher_run
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    os.makedirs(tmp_path / "data" / "train")
    cfg["data_dir"] = str(tmp_path / "data")
    path = str(tmp_path / "nofeatures.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(SystemExit, match="WavLM features"):
        distill_cli.main(["--config", path, "--teacher", teacher, "--save_dir",
                          str(tmp_path / "d"), "--device", "cpu"])
