"""The port's multi-rank paths on the CPU: gloo groups of 2 and 4 spawned
ranks (`_torch_parallel_worker.py`), each world started once for the whole
file, against the JAX package run in this process (conftest's 8 CPU devices).

* Train steps on a mesh (MDM, 2 layers, latent 128, batch 8, cosine 20,
  AdamW + EMA, condition drop 0.1, the JAX draws injected): DP, FSDP, TP
  (split q/k/v), SP and PP (M = pipe and 2·pipe) on 2 ranks; DP × TP, FSDP ×
  TP and 4-way DP on 4; the loss-second-moment sampler (its history takes
  every rank's (t, loss)). Per
  step the loss, grad norm and param norm within 1e-5 relative of the JAX
  single-device step, and the per-example losses and t of the global batch;
  the gradient (AdamW's first moment after step one, 0.1·g) at rtol 1e-4;
  the weights and EMA after three steps at 1e-5 (entries at the gradient's
  float32 noise floor to lr per step, as in `test_torch_train_step.py`); the
  losses and norms of every step within 1e-5 of the port's own one-process
  run (two-process "multihost" equals one process); ZeRO's moments 1/N the
  size.
* Sequence-parallel local attention (2 and 4 shards, T 88, w 11) against JAX
  `sequence_parallel_local_attention`, 1e-5.
* `pipeline_apply` (2 and 4 stages, M = P and 2P) against the sequential
  trunk and JAX `pipeline_apply` (M = 2P at 2 stages, P at 4), 1e-5; its
  gradients, with and without `remat`, against the sequential trunk's; MDM
  (4 stages) and MDMPlus (2) with a pipelined trunk against the JAX models'
  pipelined forward, 5e-4.
* WavLM under tensor parallelism (2) against the JAX WavLM, 1e-5 abs / 1e-4.
* MoE expert parallelism (2 ranks, 4 experts, capacity factor 1: tokens
  dropped) against the dense layer over the whole batch: the same routing, no
  flips, output, load-balance loss and gradients at 1e-5.
* Cross-layout resume: a one-process packed checkpoint resumed under `--tp
  2` and a `--tp 2` checkpoint resumed in one process: the layout converted,
  weights, moments and EMA restored exactly (1e-6).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusestylegesture_tpu import diffusion as JD
from diffusestylegesture_tpu.models import mdm as jax_mdm
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.models.mdm_plus import (MDMPlus as FlaxMDMPlus,
                                                     MDMPlusConfig as FlaxMDMPlusConfig)
from diffusestylegesture_tpu.models.transformer import (TorchEncoderLayer as FlaxLayer,
                                                        TorchTransformerEncoder as FlaxEncoder)
from diffusestylegesture_tpu.models.wavlm import WavLM as FlaxWavLM
from diffusestylegesture_tpu.models.wavlm import WavLMConfig as FlaxWavLMConfig
from diffusestylegesture_tpu.parallel import make_mesh as jax_make_mesh
from diffusestylegesture_tpu.parallel import pipeline_apply as jax_pipeline_apply
from diffusestylegesture_tpu.parallel import stack_layer_params as jax_stack
from diffusestylegesture_tpu.parallel.seq_parallel import sequence_parallel_local_attention
from diffusestylegesture_tpu.train import state as JS
from diffusestylegesture_torch import diffusion as TD
from diffusestylegesture_torch.models.convert import (encoder_layer_state_dict_from_flax,
                                                      mdm_state_dict_from_flax,
                                                      wavlm_state_dict_from_flax)
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.moe import MoEFeedForward
from diffusestylegesture_torch.models.moe import route as moe_route
from diffusestylegesture_torch.train import (LoopConfig, TrainConfig, TrainLoop, TrainState,
                                             make_train_step, make_zeggs_cond_builder)

from test_torch_train_step import assert_named_close, noise_floor_entries
from torch_port_utils import randomize_flax_params

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_parallel_worker.py")
B, NJ, T, NSEED, NT = 8, 16, 22, 4, 20
KW = dict(njoints=NJ, latent_dim=128, ff_size=64, num_layers=2, window_size=11, n_seed=NSEED,
          cond_mask_prob=0.1, dropout=0.0)
STEP_CFG = dict(lr=1e-3, weight_decay=0.01, lr_anneal_steps=10, ema_rate=0.99)
SAMPLERS = ("loss-second-moment",)
TRAIN = {
    2: {"dp": dict(axes=("data",), shape=(2,), sampler="loss-second-moment"),
        "fsdp": dict(axes=("data",), shape=(2,), sampler="loss-second-moment", fsdp=True),
        "tp": dict(axes=("data", "model"), shape=(1, 2), sampler="loss-second-moment"),
        "sp": dict(axes=("data", "seq"), shape=(1, 2), sampler="loss-second-moment"),
        "pp_m2": dict(axes=("data", "pipe"), shape=(1, 2), sampler="loss-second-moment", M=2),
        "pp_m4": dict(axes=("data", "pipe"), shape=(1, 2), sampler="loss-second-moment", M=4)},
    4: {"dp_tp": dict(axes=("data", "model"), shape=(2, 2), sampler="loss-second-moment"),
        "fsdp_tp": dict(axes=("data", "model"), shape=(2, 2), sampler="loss-second-moment",
                        fsdp=True),
        "dp4": dict(axes=("data",), shape=(4,), sampler="loss-second-moment")},
}
ENC = dict(L=4, D=64, H=4, F=96)
WAVLM = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=96,
             encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4, num_buckets=40,
             max_distance=80, conv_feature_layers=((24, 10, 5), (24, 3, 2), (24, 2, 2)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"motion": rng.standard_normal((B, T, NJ)).astype(np.float32),
            "style": rng.standard_normal((B, 6)).astype(np.float32),
            "wavlm": rng.standard_normal((B, T, 1024)).astype(np.float32)}


def _jax_runs(fmodel, params, batches):
    """Three JAX steps per sampler: the draws the port replays (t from the
    step's metrics, the noise as the step splits it, the condition drops
    recorded from its mask_cond calls), and what the step produced."""
    out = {}
    for sampler in SAMPLERS:
        jcfg = JS.TrainConfig(**STEP_CFG, schedule_sampler=sampler, dropout_rng_impl="threefry")
        step = JS.make_train_step(
            lambda p, x, t, c, train=False, rngs=None, uncond=None: fmodel.apply(
                p, x, t, c, train=train, rngs=rngs, uncond=uncond),
            JD.Schedule.create(JD.named_beta_schedule("cosine", NT)), jcfg,
            JS.make_zeggs_cond_builder(NSEED))
        state = JS.create_train_state(params, jcfg, NT)
        drops, draws, steps = [], [], []
        real = jax_mdm.mask_cond

        def recording(c, *, cond_mask_prob, train, uncond=None, rng=None):
            if train and cond_mask_prob > 0.0:
                drops.append(np.asarray(jax.random.bernoulli(rng, cond_mask_prob,
                                                             (c.shape[0], 1)))[:, 0])
            return real(c, cond_mask_prob=cond_mask_prob, train=train, uncond=uncond, rng=rng)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_mdm, "mask_cond", recording)
            for i, batch in enumerate(batches):
                key = jax.random.PRNGKey(100 + i)
                state, m = step(state, batch, key)
                _, rng_noise, _, _ = jax.random.split(key, 4)
                noise = np.asarray(jax.random.normal(rng_noise, (B, NJ, 1, T), jnp.float32))
                draws.append(dict(t=np.asarray(m["t"]).astype(np.int64), noise=noise,
                                  drops=tuple(drops[-2:])))
                rec = {k: np.asarray(m[k]) for k in ("loss", "grad_norm", "param_norm",
                                                     "loss_per_example")}
                if i == 0:
                    rec["mu"] = mdm_state_dict_from_flax(jax.device_get(state.opt_state[0].mu))
                steps.append(rec)
        out[sampler] = dict(draws=draws, steps=steps,
                            params=mdm_state_dict_from_flax(jax.device_get(state.params)),
                            ema=mdm_state_dict_from_flax(jax.device_get(state.ema_params)))
    return out


def _port_one_process(task, sampler):
    """The port's own run of the same steps on one process, no mesh."""
    model = MDM(MDMConfig(**task["mdm_kw"], impl="plain"))
    model.load_state_dict(task["model_sd"])
    cfg = TrainConfig(**task["train_cfg"], schedule_sampler=sampler)
    state = TrainState(model, cfg, NT)
    step = make_train_step(TD.Schedule.create(TD.named_beta_schedule("cosine", NT),
                                              device="cpu"), cfg, make_zeggs_cond_builder(NSEED))
    losses, noisy = [], {}
    for batch, d in zip(task["batches"], task["draws"][sampler]):
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                 t=torch.from_numpy(d["t"]), noise=torch.from_numpy(d["noise"]),
                 cond_drop=tuple(torch.from_numpy(a) for a in d["drops"]))
        losses.append([float(m[k]) for k in ("loss", "grad_norm", "param_norm")])
        noise_floor_entries(state, noisy)
    return losses, state.params.to_dict(state.params.data), noisy


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, task_path, out_dir):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE",
                                                          "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(port),
                               task_path, out_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=420)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(logs)[-6000:])
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs, JAX references and the one-process port runs, shared by both worlds."""
    root = tmp_path_factory.mktemp("parallel")
    fmodel = FlaxMDM(FlaxMDMConfig(**KW))
    batches = [_batch(10 + i) for i in range(3)]
    x = jnp.zeros((B, NJ, 1, T))
    cond = {"seed": x[..., :NSEED], "style": jnp.asarray(batches[0]["style"]),
            "audio": jnp.asarray(batches[0]["wavlm"]), "mask_local": jnp.ones((B, T), bool)}
    params = jax.jit(fmodel.init)(jax.random.PRNGKey(0), x, jnp.zeros((B,), jnp.int32), cond)
    params = {"params": randomize_flax_params(params["params"], 0)}
    jax_runs = _jax_runs(fmodel, params, batches)
    rng = np.random.default_rng(5)

    # sequence-parallel attention: every row keeps a key (each window's first)
    heads, w, n, d = 4, 11, 88, 16
    q, k, v = (rng.standard_normal((2 * heads, n, d)).astype(np.float32) for _ in range(3))
    mask = rng.random((2, n)) > 0.3
    mask[:, ::w] = True
    attention = dict(q=q, k=k, v=v, mask=mask, w=w, heads=heads)

    # the pipelined trunk
    enc = FlaxEncoder(num_layers=ENC["L"], d_model=ENC["D"], nhead=ENC["H"],
                      dim_feedforward=ENC["F"], dropout=0.0)
    xe = rng.standard_normal((8, 12, ENC["D"])).astype(np.float32)
    eparams = jax.jit(enc.init)(jax.random.PRNGKey(3), jnp.asarray(xe))
    eparams = {"params": randomize_flax_params(eparams["params"], 3)}
    esd = {}
    for i in range(ENC["L"]):
        esd.update(encoder_layer_state_dict_from_flax(eparams["params"][f"layers_{i}"],
                                                      f"layers.{i}."))
    pipeline = dict(ENC, sd=esd, x=xe, flax=(enc, eparams))

    def denoiser(cls, cfg_cls, kw, cond):
        fm = cls(cfg_cls(**kw))
        xs = rng.standard_normal((4,) + cond["x_shape"]).astype(np.float32)
        t = np.array([3, 7, 0, 12])
        c = {k: v for k, v in cond.items() if k != "x_shape"}
        p = jax.jit(fm.init)(jax.random.PRNGKey(4), jnp.asarray(xs), jnp.asarray(t),
                             {k: jnp.asarray(v) for k, v in c.items()})
        p = {"params": randomize_flax_params(p["params"], 4)}
        return dict(kw=kw, sd=mdm_state_dict_from_flax(p), x=xs, t=t, cond=c,
                    flax=(cls, cfg_cls, p))

    mkw = dict(njoints=NJ, latent_dim=128, ff_size=64, num_layers=4, n_seed=NSEED, dropout=0.0,
               cond_mask_prob=0.0)
    mdm_pipe = denoiser(FlaxMDM, FlaxMDMConfig, mkw, dict(
        x_shape=(NJ, 1, T), seed=rng.standard_normal((4, NJ, 1, NSEED)).astype(np.float32),
        style=rng.standard_normal((4, 6)).astype(np.float32),
        audio=rng.standard_normal((4, T, 1024)).astype(np.float32),
        mask_local=np.ones((4, T), bool)))
    pkw = dict(njoints=36, latent_dim=96, ff_size=64, num_layers=4, source_audio_dim=40,
               audio_feat_dim=32, style_dim_in=4, n_seed=5, window_size=15, dropout=0.0,
               cond_mask_prob=0.0)
    plus_pipe = denoiser(FlaxMDMPlus, FlaxMDMPlusConfig, pkw, dict(
        x_shape=(36, 1, 30), seed=rng.standard_normal((4, 36, 1, 5)).astype(np.float32),
        style=np.eye(4, dtype=np.float32)[[0, 1, 2, 3]],
        audio=rng.standard_normal((4, 25, 40)).astype(np.float32),
        mask_local=np.ones((4, 30), bool)))

    # WavLM
    fw = FlaxWavLM(FlaxWavLMConfig(**WAVLM))
    wav = rng.standard_normal((2, 4000)).astype(np.float32)
    wparams = jax.jit(fw.init)(jax.random.PRNGKey(1), jnp.asarray(wav))
    wparams = {"params": randomize_flax_params(wparams["params"], 1)}
    from diffusestylegesture_torch.models.wavlm.model import WavLMConfig

    wsd = wavlm_state_dict_from_flax(wparams, WavLMConfig(**WAVLM))
    wavlm = dict(cfg=WAVLM, sd=wsd, wav=wav,
                 ref=np.asarray(jax.jit(fw.apply)(wparams, jnp.asarray(wav))))

    # MoE: capacity factor 1 over 48 tokens and 4 experts drops some
    torch.manual_seed(6)
    moe_layer = MoEFeedForward(32, 48, 4, 1.0)
    moe = dict(D=32, F=48, E=4, cf=1.0, sd=moe_layer.state_dict(),
               x=rng.standard_normal((4, 12, 32)).astype(np.float32))

    # a one-process packed checkpoint at step 2 for the resume job
    packed_dir, tp_dir = str(root / "packed"), str(root / "tp")
    model_sd = mdm_state_dict_from_flax(params)
    _loop(model_sd, batches, packed_dir, 2).run()

    task = dict(mdm_kw={**KW}, model_sd=model_sd, batches=batches, num_timesteps=NT,
                n_seed=NSEED, train_cfg=STEP_CFG, train=TRAIN,
                draws={s: jax_runs[s]["draws"] for s in SAMPLERS}, attention=attention,
                pipeline={k: v for k, v in pipeline.items() if k != "flax"},
                mdm_pipe={k: v for k, v in mdm_pipe.items() if k != "flax"},
                mdm_plus_pipe={k: v for k, v in plus_pipe.items() if k != "flax"},
                wavlm={k: v for k, v in wavlm.items() if k != "ref"}, moe=moe,
                resume=dict(packed_dir=packed_dir, tp_dir=tp_dir))
    task_path = str(root / "task.pt")
    torch.save(task, task_path)
    one = {s: _port_one_process(task, s) for s in SAMPLERS}
    return dict(root=root, task=task, task_path=task_path, jax=jax_runs, one=one,
                attention=attention, pipeline=pipeline, mdm_pipe=mdm_pipe,
                plus_pipe=plus_pipe, wavlm=wavlm, moe_layer=moe_layer, moe=moe,
                packed_dir=packed_dir, tp_dir=tp_dir)


def _loop(model_sd, batches, ckpt, steps, split=False):
    model = MDM(MDMConfig(**KW, split_qkv=split, impl="plain"))
    model.load_state_dict(model_sd)
    return TrainLoop(model, TD.Schedule.create(TD.named_beta_schedule("cosine", 20),
                                               device="cpu"),
                     iter([dict(b) for b in batches] * 2), train_cfg=TrainConfig(**STEP_CFG),
                     loop_cfg=LoopConfig(num_steps=steps, log_interval=100, save_interval=0,
                                         checkpoint_dir=ckpt),
                     cond_builder=make_zeggs_cond_builder(NSEED), seed=5)


_WORLDS = {}


def _world(setup, world):
    if world not in _WORLDS:
        out = setup["root"] / f"world{world}"
        out.mkdir()
        _WORLDS[world] = _spawn(world, setup["task_path"], str(out))
    return _WORLDS[world]


TRAIN_CASES = [(w, name) for w, jobs in TRAIN.items() for name in jobs]


@pytest.mark.parametrize("world,name", TRAIN_CASES, ids=[f"{w}x{n}" for w, n in TRAIN_CASES])
def test_train_step_on_a_mesh_matches_jax(setup, world, name):
    spec = TRAIN[world][name]
    ref = setup["jax"][spec["sampler"]]
    ranks = _world(setup, world)
    got = [r[f"train/{name}"] for r in ranks]
    # every rank holds the same global metrics and weights
    for other in got[1:]:
        for i, st in enumerate(other["steps"]):
            np.testing.assert_array_equal(st["loss"], got[0]["steps"][i]["loss"])
    res = got[0]
    losses, _, noisy = setup["one"][spec["sampler"]]
    for i, (st, jst) in enumerate(zip(res["steps"], ref["steps"])):
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(st[k], jst[k], rtol=1e-5, err_msg=f"{name} {i} {k}")
        np.testing.assert_allclose(st["loss_per_example"], jst["loss_per_example"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(st["t"], setup["task"]["draws"][spec["sampler"]][i]["t"])
    # the reduced gradient of step one: AdamW's first moment, 0.1·g
    for k, mu in ref["steps"][0]["mu"].items():
        g = mu.numpy()
        np.testing.assert_allclose(res["steps"][0]["mu"][k].numpy(), g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max(), err_msg=f"{name} mu {k}")
    bound = STEP_CFG["lr"] * 3
    assert_named_close(res["params"], ref["params"], f"{name} params", noisy, bound,
                       rtol=1e-5, atol=1e-5)
    assert_named_close(res["ema"], ref["ema"], f"{name} ema", noisy, bound, rtol=1e-5, atol=1e-5)
    # two processes (or four) equal one: the losses and norms of every step
    np.testing.assert_allclose([[float(s[k]) for k in ("loss", "grad_norm", "param_norm")]
                                for s in res["steps"]], losses, rtol=1e-5)
    if spec.get("fsdp"):
        data = spec["shape"][0]
        assert res["moment_numel"] == -(-res["flat_numel"] // data)


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_attention_matches_jax(setup, world):
    a = setup["attention"]
    mesh = jax_make_mesh(axes=("seq",), shape=(world,), devices=jax.devices()[:world])
    ref = sequence_parallel_local_attention(
        *(jnp.asarray(a[n]) for n in ("q", "k", "v")), a["w"], mesh, mask=jnp.asarray(a["mask"]),
        heads=a["heads"], batch_axis=None)
    for r in _world(setup, world):
        np.testing.assert_allclose(r["attention"], np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_apply_matches_jax_and_the_loop(setup, world):
    p = setup["pipeline"]
    enc, eparams = p["flax"]
    x = jnp.asarray(p["x"])
    loop = np.asarray(enc.apply(eparams, x))
    stacked = jax_stack(eparams["params"], p["L"])

    def layer_fn(lp, h, key):
        return FlaxLayer(p["D"], p["H"], p["F"], 0.0).apply({"params": lp}, h, True)

    mesh = jax_make_mesh(axes=("pipe",), shape=(world,), devices=jax.devices()[:world])
    M_jax = 2 * world if world == 2 else world
    ref = np.asarray(jax_pipeline_apply(stacked, x, layer_fn, mesh, num_microbatches=M_jax))
    np.testing.assert_allclose(ref, loop, atol=1e-5)
    for r in _world(setup, world):
        np.testing.assert_allclose(r["pipeline"][f"M{M_jax}"], ref, atol=1e-5)
        for M in (world, 2 * world):
            np.testing.assert_allclose(r["pipeline"][f"M{M}"], loop, atol=1e-5)


def test_pipeline_gradients_match_the_loop(setup):
    from diffusestylegesture_torch.models.transformer import TorchTransformerEncoder

    p = setup["pipeline"]
    enc = TorchTransformerEncoder(p["L"], p["D"], p["H"], p["F"])
    enc.load_state_dict(p["sd"])
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    (enc(x, impl="plain", train=True) ** 2).sum().backward()
    ref = {"x": x.grad.numpy(), **{n: q.grad.numpy() for n, q in enc.named_parameters()}}
    for world in (2, 4):
        for r in _world(setup, world):
            for remat in ("remat0", "remat1"):
                got = r["pipeline"]["grads"][remat]
                for k, g in ref.items():
                    np.testing.assert_allclose(got[k], g, rtol=1e-4, atol=1e-5 * np.abs(g).max(),
                                               err_msg=f"{world} {remat} {k}")


@pytest.mark.parametrize("name", ["mdm", "mdm_plus"])
def test_pipelined_denoisers_match_jax(setup, name):
    d = setup["mdm_pipe" if name == "mdm" else "plus_pipe"]
    cls, cfg_cls, params = d["flax"]
    for world in ((4,) if name == "mdm" else (2,)):
        mesh = jax_make_mesh(axes=("pipe",), shape=(world,), devices=jax.devices()[:world])
        fm = cls(cfg_cls(**d["kw"], trunk_impl="pipeline", pipe_mesh=mesh))
        ref = np.asarray(fm.apply(params, jnp.asarray(d["x"]), jnp.asarray(d["t"]),
                                  {k: jnp.asarray(v) for k, v in d["cond"].items()}))
        for r in _world(setup, world):
            np.testing.assert_allclose(r["pipeline"][name], ref, atol=5e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_keeps_its_host_rows(setup, world):
    for r, res in enumerate(_world(setup, world)):
        np.testing.assert_array_equal(res["host_local"], np.full((2, 3), float(r)))


def test_wavlm_tensor_parallel_matches_jax(setup):
    for r in _world(setup, 2):
        np.testing.assert_allclose(r["wavlm"], setup["wavlm"]["ref"], atol=1e-5, rtol=1e-4)


def test_moe_expert_parallel_matches_dense(setup):
    m = setup["moe"]
    layer = MoEFeedForward(m["D"], m["F"], m["E"], m["cf"])
    layer.load_state_dict(m["sd"])
    x = torch.from_numpy(m["x"]).requires_grad_(True)
    y, aux = layer(x)
    ((y ** 2).sum() + aux).backward()
    # some tokens are dropped at this capacity: the routing is the point
    xf = x.detach().reshape(-1, m["D"])
    from diffusestylegesture_torch.models.moe import capacity

    *_, keep = moe_route(xf, layer.router, m["E"], capacity(xf.shape[0], m["E"], m["cf"]))
    assert 0 < int(keep.sum()) < xf.shape[0]
    for r in _world(setup, 2):
        got = r["moe"]
        # no routing flips: the dropped tokens are the dense layer's (their output is 0)
        np.testing.assert_array_equal(np.all(got["y"] == 0, axis=-1).reshape(-1),
                                      ~keep.numpy())
        np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-5)
        np.testing.assert_allclose(got["x_grad"], x.grad.numpy(), atol=1e-5)
        for n, q in layer.named_parameters():
            g = q.grad.numpy()
            np.testing.assert_allclose(got["grads"][n], g, rtol=1e-4,
                                       atol=1e-5 * max(np.abs(g).max(), 1.0), err_msg=n)


def test_cross_layout_resume(setup):
    ranks = _world(setup, 2)
    saved = torch.load(os.path.join(setup["packed_dir"], "2", "model.pt"), weights_only=True)
    for r in ranks:
        res = r["resume"]["resumed"]
        assert res["resume_step"] == 2 and res["split"] and res["step"] == 4
        for k, v in saved.items():
            np.testing.assert_allclose(res["restored"]["params"][k].numpy(), v.numpy(), atol=1e-6)
        assert r["resume"]["written"]["step"] == 2
    # the --tp 2 run's checkpoint: packed on disk, resumed in one process
    written = torch.load(os.path.join(setup["tp_dir"], "2", "model.pt"), weights_only=True)
    assert any(k.endswith("in_proj_weight") for k in written)
    assert not any(k.endswith("q_proj.weight") for k in written)
    loop = _loop(setup["task"]["model_sd"], setup["task"]["batches"], setup["tp_dir"], 4)
    assert loop.resume_step == 2
    names = loop.state.params.names
    assert any("in_proj" in n for n in names) and not any("q_proj" in n for n in names)
    for k, v in written.items():
        np.testing.assert_allclose(loop.state.params.to_dict(loop.state.params.data)[k].numpy(),
                                   v.numpy(), atol=1e-6)
    assert loop.run().step == 4
