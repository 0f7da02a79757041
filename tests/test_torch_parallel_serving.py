"""Serving over a mesh (`generate(mesh=)`): the port's single-process mesh of
two CPU replicas against the JAX engine under a 2-device mesh and against the
port's own unsharded run.

* ZEGGS, even batch: the port's meshed output within 2e-3 relative of JAX
  `generate(mesh=)` on the same injected x_T (dpmpp5) and of the port's
  unsharded run; odd batch (which a JAX mesh cannot split): against JAX
  unsharded and the port's unsharded run. Without injected noise (DDPM), the
  meshed run draws what the unsharded run draws (each card draws the whole
  batch and keeps its rows), and its crossfade takes the whole batch's n:
  the same output, and the caller's generator left where the unsharded run
  leaves it.
* BEAT/TWH `+` (attention4), even and odd batch, against JAX
  `generate(mesh=)` / unsharded and the port's unsharded run.
* The replicas and their runs are made once per card; a mesh without a
  `data` axis is refused.
"""
import numpy as np
import pytest
import torch

import jax

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.models.wavlm import make_zeggs_wavlm_fn as jax_make_zeggs_wavlm_fn
from diffusestylegesture_tpu.parallel import make_mesh as jax_make_mesh
from diffusestylegesture_tpu.sample import engine as jax_engine
from diffusestylegesture_tpu.sample import engine_beat as jax_engine_beat
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.models.wavlm import make_zeggs_wavlm_fn
from diffusestylegesture_torch.parallel import make_mesh
from diffusestylegesture_torch.sample import engine as torch_engine

import test_torch_engine_beat as beat
from torch_port_utils import ZEGGS_TINY_NJ as NJ, rel_err, zeggs_tiny_pair

CPU = torch.device("cpu")
WINDOWS = 2


@pytest.fixture(scope="module")
def pair():
    p = zeggs_tiny_pair(0)
    rng = np.random.default_rng(7)
    p["audio"] = (rng.standard_normal(WINDOWS * 80 * 800 + 55) * 0.1).astype(np.float32)
    p["noise"] = rng.standard_normal((WINDOWS, 4, NJ, 1, 88)).astype(np.float32)
    return p


def _zeggs(sampler="dpmpp", steps=5):
    betas = TD.named_beta_schedule("cosine", 1000)
    sched = TD.spaced_schedule(betas, TD.space_timesteps(1000, f"ddim{steps}"), device="cpu")
    cfg = torch_engine.ZeggsEngineConfig(njoints=NJ, sampler=sampler)
    return torch_engine.ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                                     make_zeggs_wavlm_fn(88), sched, cfg, device="cpu")


def _jax_zeggs(p, steps=5):
    betas = JD.named_beta_schedule("cosine", 1000)
    sched = JD.spaced_schedule(betas, JD.space_timesteps(1000, f"ddim{steps}"))
    cfg = jax_engine.ZeggsEngineConfig(njoints=NJ, sampler="dpmpp")
    return jax_engine.ZeggsSampler(
        lambda q, x, t, c, uncond=None: p["fm"].apply(q, x, t, c, uncond=uncond),
        jax_make_zeggs_wavlm_fn(p["fw"], 88), sched, cfg)


@pytest.mark.parametrize("batch", [2, 3], ids=["even", "odd"])
def test_zeggs_mesh_matches_jax_and_unsharded(pair, batch):
    p = pair
    style = np.eye(6, dtype=np.float32)[[0, 3, 5][:batch]]
    noise = p["noise"][:, :batch]
    stats = dict(mean=p["mean"], std=p["std"])
    jmesh = jax_make_mesh(devices=jax.devices()[:2]) if batch % 2 == 0 else None
    ref = _jax_zeggs(p).generate(p["mparams"], p["wparams"], p["audio"], style,
                                 jax.random.PRNGKey(0), noise_windows=noise, mesh=jmesh, **stats)
    sampler = _zeggs()
    meshed = sampler.generate(p["mdm"], p["wavlm"], p["audio"], style, None, noise_windows=noise,
                              mesh=make_mesh(devices=[CPU, CPU]), **stats)
    unsharded = _zeggs().generate(p["mdm"], p["wavlm"], p["audio"], style, None,
                                  noise_windows=noise, **stats)
    assert meshed.shape == ref.shape == (batch, WINDOWS * 80 - 8, NJ)
    assert rel_err(meshed, ref) < 2e-3
    assert rel_err(meshed, unsharded) < 2e-3
    # one lane a card, the first on the sampler itself, each with its rows
    assert len(sampler._replicas) == 1 and len(sampler.lane_launches) == 2


@pytest.mark.parametrize("batch", [2, 3], ids=["even", "odd"])
def test_zeggs_mesh_draws_what_the_unsharded_run_draws(pair, batch):
    p = pair
    style = np.eye(6, dtype=np.float32)[[1, 2, 4][:batch]]
    outs, states = [], []
    for mesh in (None, make_mesh(devices=[CPU, CPU])):
        g = torch.Generator().manual_seed(11)
        outs.append(_zeggs("ddpm", 4).generate(p["mdm"], p["wavlm"], p["audio"], style, g,
                                               mesh=mesh, mean=p["mean"], std=p["std"]))
        states.append(g.get_state())
    assert rel_err(outs[1], outs[0]) < 2e-3
    assert torch.equal(states[0], states[1])


def test_zeggs_mesh_reuses_its_replicas(pair):
    p = pair
    sampler = _zeggs()
    mesh = make_mesh(devices=[CPU, CPU, CPU])
    style = np.eye(6, dtype=np.float32)[[0, 1, 2, 3]]
    kw = dict(noise_windows=p["noise"], mesh=mesh, mean=p["mean"], std=p["std"])
    first = sampler.generate(p["mdm"], p["wavlm"], p["audio"], style, None, **kw)
    replicas = dict(sampler._replicas)
    second = sampler.generate(p["mdm"], p["wavlm"], p["audio"], style, None, **kw)
    np.testing.assert_array_equal(first, second)
    assert sampler._replicas == replicas and len(replicas) == 2
    # rows 2 / 1 / 1 over three cards
    assert sorted(k[0] for r in [sampler] + list(replicas.values()) for k in r._runs) == [1, 1, 2]


def test_mesh_without_a_data_axis_is_refused(pair):
    p = pair
    with pytest.raises(ValueError, match="data"):
        _zeggs().generate(p["mdm"], p["wavlm"], p["audio"], np.eye(6, dtype=np.float32)[:2],
                          None, mesh=make_mesh(("model",), devices=[CPU]), mean=p["mean"],
                          std=p["std"])


@pytest.mark.parametrize("batch", [2, 3], ids=["even", "odd"])
def test_beat_twh_mesh_matches_jax_and_unsharded(batch):
    s = beat._shared("attention4")
    betas = JD.named_beta_schedule("cosine", 1000)
    jsched = JD.spaced_schedule(betas, JD.space_timesteps(1000, f"ddim{beat.STEPS}"))
    jsampler = jax_engine_beat.BeatTwhSampler(
        lambda q, x, t, c, uncond=None: s["fm"].apply(q, x, t, c, uncond=uncond), jsched,
        beat._cfg(jax_engine_beat, "attention4", "ddim"))
    style = np.eye(beat.STYLE, dtype=np.float32)[[0, 2, 3][:batch]]
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((beat.WINDOWS, batch, beat.NJ, 1, beat.N_POSES)).astype(
        np.float32)
    jmesh = jax_make_mesh(devices=jax.devices()[:2]) if batch % 2 == 0 else None
    ref = jsampler.generate(s["params"], s["textaudio"], s["seed"], style, jax.random.PRNGKey(1),
                            s["mean"], s["std"], noise_windows=noise, mesh=jmesh)
    args = (s["model"], s["textaudio"], s["seed"], style, None, s["mean"], s["std"])
    meshed = beat._torch_sampler("attention4", "ddim").generate(
        *args, noise_windows=noise, mesh=make_mesh(devices=[CPU, CPU]))
    unsharded = beat._torch_sampler("attention4", "ddim").generate(*args, noise_windows=noise)
    assert meshed.shape == ref.shape == (batch, beat.REAL_N, beat.NJ // 3)
    assert rel_err(meshed, ref) < 2e-3
    assert rel_err(meshed, unsharded) < 2e-3
