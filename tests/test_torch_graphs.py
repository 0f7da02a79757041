"""The engine's CUDA graphs against its eager loop, on the card.

Imports neither jax nor the JAX package, so it runs on a machine with a card
and no JAX (there, skip the conftest, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_graphs.py

On the same inputs and generator seed, the graph path (`ZeggsSampler` on
CUDA) and the eager comparison path (`graphs=False`) give bitwise-equal poses
for every sampler, with and without classifier-free guidance, and for
`generate_multi_clip`; the generator ends in the same state; the launch
counters read the same after replays as after eager calls; a capture that
fails raises; a capture survives finished graphs turning into cyclic garbage
while it runs (the collector is paused); `--serve_fast` stays within the bench
gate's 2e-2 of float32. The graphs read the conditioning invariants each
window computes once; they equal, bitwise, the eager path that computes them
at every step (the model behind `PerStep`) in each of these comparisons.
The training-style steps captured by `graphs.CapturedStep` (the device-cache
train step in float32 and bf16, the distillation step with its teacher
through kernels A and B, the autoencoder step) equal their eager steps
bitwise over three steps; a step capture that fails raises. The BEAT/TWH
engine (`BeatTwhSampler`) gives bitwise-equal poses on graphs and eagerly for
each variant, with CFG, and attention5 reads a new `seed_last` at the next
call on the same captured graphs.
Elsewhere every test skips but these: the collector's pause and restore;
`ProgramRun` with graphs off against its `run()` and the samplers' eager loop
functions; `use_graphs` refusing graphs off a CUDA device.
"""
import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffusestylegesture_torch import diffusion as D
from diffusestylegesture_torch import resolve_device
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig, make_zeggs_wavlm_fn
from diffusestylegesture_torch.models.mdm_plus import MDMPlus, MDMPlusConfig
from diffusestylegesture_torch.sample import (BeatEngineConfig, BeatTwhSampler, ZeggsEngineConfig,
                                              ZeggsSampler, generate_multi_clip)
from diffusestylegesture_torch.utils import graphs

from test_torch_isolation import TINY_WAVLM
from torch_port_utils import PerStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NJ = 64
BF16_TOL = 2e-2  # bench.py


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    models = {}
    for name, dtype, act in (("f32", torch.float32, "gelu"),
                             ("bf16", torch.bfloat16, "gelu_tanh")):
        mdm = MDM(MDMConfig(njoints=NJ, latent_dim=128, ff_size=256, num_layers=2,
                            audio_in_dim=32, dtype=dtype, activation=act))
        if models:
            mdm.load_state_dict(models["f32"][0].state_dict())
        wavlm = WavLM(WavLMConfig(**TINY_WAVLM, dtype=dtype))
        if models:
            wavlm.load_state_dict(models["f32"][1].state_dict())
        models[name] = (mdm.to(dev).eval(), wavlm.to(dev).eval())
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(3 * 80 * 800 + 500) * 0.1).astype(np.float32)
    return dict(dev=dev, models=models, audio=audio)


def _sampler(dev, sampler, steps, guidance=0.0, graphs_on=None, **kw):
    betas = D.named_beta_schedule("cosine", 1000)
    sched = (D.Schedule.create(betas, device=dev) if steps == 1000 else
             D.spaced_schedule(betas, D.space_timesteps(1000, f"ddim{steps}"), device=dev))
    return ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                        make_zeggs_wavlm_fn(88), sched,
                        ZeggsEngineConfig(njoints=NJ, sampler=sampler, guidance_scale=guidance,
                                          **kw),
                        device=dev, graphs=graphs_on)


def _both(card, sampler, steps, guidance=0.0, styles=(0,), model="f32"):
    """Per path, (poses, launch counts, final generator state, sampler): the
    graphs, the eager loop, and the eager loop that computes the conditioning
    invariants at every step (`per_step`)."""
    mdm, wavlm = card["models"][model]
    style = np.eye(6, dtype=np.float32)[list(styles)]
    out = {}
    for path, flag in (("graph", None), ("eager", False), ("per_step", False)):
        s = _sampler(card["dev"], sampler, steps, guidance, graphs_on=flag)
        gen = torch.Generator(device=card["dev"]).manual_seed(42)
        before = graphs.launch_counts()
        poses = s.generate(PerStep(mdm) if path == "per_step" else mdm, wavlm, card["audio"],
                           style, gen)
        counts = tuple(b - a for a, b in zip(before, graphs.launch_counts()))
        out[path] = (poses, counts, gen.get_state(), s)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("guidance", [0.0, 1.5], ids=["plain", "cfg"])
@pytest.mark.parametrize("sampler,steps", [("ddpm", 10), ("ddim", 10), ("plms", 10),
                                           ("dpmpp", 5)])
def test_cuda_graph_equals_eager(card, sampler, steps, guidance):
    out = _both(card, sampler, steps, guidance)
    g, e, p = out["graph"], out["eager"], out["per_step"]
    assert g[3].graphs and not e[3].graphs and g[3].capture_seconds > 0
    assert np.isfinite(g[0]).all() and g[0].shape == (1, 3 * 80 - 8, NJ)
    assert np.array_equal(g[0], e[0]) and np.array_equal(g[0], p[0])
    assert torch.equal(g[2], e[2]) and torch.equal(g[2], p[2])  # the generator advanced alike
    assert (g[3].cond_encodes, p[3].cond_encodes) == (0 if guidance else 3, 0)
    calls = 3 * (steps + (1 if sampler == "plms" else 0))
    assert g[1] == e[1] and g[1][:3] == (calls, 2 * calls, 0)


@pytest.mark.cuda
def test_cuda_graph_equals_eager_ddpm1000_batched(card):
    out = _both(card, "ddpm", 1000, styles=(0, 4))
    assert np.array_equal(out["graph"][0], out["eager"][0])
    assert np.array_equal(out["graph"][0], out["per_step"][0])
    assert out["graph"][3].cond_encodes == 3
    assert out["graph"][1] == out["eager"][1] and out["graph"][1][:3] == (3000, 6000, 0)


@pytest.mark.cuda
def test_cuda_graph_equals_eager_multi_clip(card):
    mdm, wavlm = card["models"]["f32"]
    audios = [card["audio"], card["audio"][: 80 * 800 + 100], card["audio"][:9000]]
    styles = np.eye(6, dtype=np.float32)[[1, 2, 3]]
    res = {}
    for path, flag in (("graph", None), ("eager", False), ("per_step", False)):
        gen = torch.Generator(device=card["dev"]).manual_seed(7)
        res[path] = generate_multi_clip(_sampler(card["dev"], "dpmpp", 5, graphs_on=flag),
                                        PerStep(mdm) if path == "per_step" else mdm,
                                        wavlm, audios, styles, gen)
    assert [r.shape for r in res["graph"]] == [(232, NJ), (72, NJ), (0, NJ)]
    for a, b, c in zip(res["graph"], res["eager"], res["per_step"]):
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.cuda
def test_cuda_graph_is_reused_across_calls(card):
    mdm, wavlm = card["models"]["f32"]
    s = _sampler(card["dev"], "dpmpp", 5)
    style = np.eye(6, dtype=np.float32)[:1]
    first = s.generate(mdm, wavlm, card["audio"], style,
                       torch.Generator(device=card["dev"]).manual_seed(1))
    captured = s.capture_seconds
    again = s.generate(mdm, wavlm, card["audio"], style,
                       torch.Generator(device=card["dev"]).manual_seed(1))
    assert s.capture_seconds == captured  # no second capture
    assert np.array_equal(first, again)


@pytest.mark.cuda
def test_cuda_serve_fast_within_bf16_gate(card):
    res = {name: _both(card, "dpmpp", 5, model=name)["graph"] for name in ("f32", "bf16")}
    f32, bf16 = res["f32"][0], res["bf16"][0]
    assert res["bf16"][1] == (15, 0, 30, 0)  # kernel B in its bf16 mode only, no weight planes
    err = float(np.sqrt(np.mean((bf16 - f32) ** 2)) / f32.std())
    assert err <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ddim", "dpmpp"])
def test_cuda_inpaint_inside_captured_steps(card, name):
    """The inpaint mask and motion are read where they lie: refilled between
    runs, the captured steps see the new values, as the eager steps do."""
    from diffusestylegesture_torch.diffusion.sampling import PROGRAMS

    dev = card["dev"]
    shape = (2, NJ, 1, 88)
    w = torch.randn(shape[1:], generator=torch.Generator().manual_seed(3)).to(dev)
    sched = D.spaced_schedule(D.named_beta_schedule("cosine", 1000),
                              D.space_timesteps(1000, "ddim10"), device=dev)
    mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    motion = torch.zeros(shape, device=dev)
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(dev)
    prog = PROGRAMS[name](sched, lambda x, t: torch.tanh(0.7 * x + w), shape, None,
                          inpaint=(mask, motion))
    gs = graphs.GraphSet(dev)
    steps = [gs.capture(p.fn, prepare=lambda: prog.idx.fill_(prog.t0))[0] for p in prog.phases]
    for half in (44, 30):  # refill the buffers between runs
        mask.zero_()
        mask[..., :half] = True
        motion.copy_(torch.randn(shape, generator=torch.Generator().manual_seed(half)).to(dev))
        prog.init(noise)
        eager = prog.run().clone()
        prog.init(noise)
        for phase, step in zip(prog.phases, steps):
            step.replay(phase.count)
        assert torch.equal(prog.img, eager)
        assert torch.allclose(prog.img[mask], motion[mask], atol=1e-5)


@pytest.mark.cuda
def test_cuda_failed_capture_raises(card):
    """In a process of its own: PyTorch leaves the default CUDA generator in
    capture mode after a failed capture, and later draws in that process raise."""
    code = ("import torch\n"
            "from diffusestylegesture_torch.utils.graphs import GraphSet\n"
            "x = torch.ones(4, device='cuda')\n"
            "try:\n"
            "    GraphSet(x.device).capture(lambda: x.sum().item())  # a host read\n"
            "except RuntimeError:\n"
            "    raise SystemExit(0)\n"
            "raise SystemExit('the capture did not raise')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr



def test_collector_paused_restores_the_collector():
    """Captures pause Python's cyclic collector and restore it as it was."""
    assert gc.isenabled()
    with graphs._collector_paused():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with graphs._collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()
    with pytest.raises(KeyError):
        with graphs._collector_paused():
            raise KeyError("x")
    assert gc.isenabled()


LOOPS = {"ddpm": D.p_sample_loop, "ddim": D.ddim_sample_loop, "plms": D.plms_sample_loop,
         "dpmpp": D.dpmpp2m_sample_loop}


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_program_run_steps_equal_run_and_the_eager_loop(name):
    """`ProgramRun` with graphs off: `begin` + `steps()` takes one step a
    `next`, Σ phase.count of them, and leaves what `run()` and the sampler's
    loop function leave from the same generator state."""
    from diffusestylegesture_torch.diffusion.sampling import PROGRAMS

    sched = D.spaced_schedule(D.named_beta_schedule("cosine", 1000),
                              D.space_timesteps(1000, "ddim10"), device="cpu")
    shape = (2, NJ, 1, 8)
    w = torch.randn(shape[1:], generator=torch.Generator().manual_seed(3))
    cfg = D.SamplerConfig(eta=0.5)  # DDIM draws noise too

    def model_fn(x, t):
        return torch.tanh(0.7 * x + w) * (1.0 + t[:, None, None, None] / 1000.0)

    def new_run():
        return graphs.ProgramRun(PROGRAMS[name](sched, model_fn, shape,
                                                torch.Generator().manual_seed(11), cfg=cfg),
                                 False)

    stepped, whole = new_run(), new_run()
    stepped.begin()
    taken = sum(1 for _ in stepped.steps())
    assert taken == sum(ph.count for ph in stepped.program.phases) and len(stepped.program.phases) > 1
    assert stepped.graph_set is None and stepped.graphs is None and stepped.capture_seconds == 0.0
    whole.begin()
    assert whole.run() is whole.program.img
    loop = LOOPS[name](sched, model_fn, shape, torch.Generator().manual_seed(11), cfg=cfg)
    assert torch.equal(stepped.program.img, whole.program.img)
    assert torch.equal(stepped.program.img, loop)
    assert torch.equal(stepped.generator.get_state(), whole.generator.get_state())


def test_use_graphs_captures_only_on_a_cuda_device():
    cpu = torch.device("cpu")
    assert graphs.use_graphs(cpu, None) is False and graphs.use_graphs(cpu, False) is False
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graphs.use_graphs(cpu, True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["graph_set", "captured_step"])
def test_cuda_capture_survives_cyclic_garbage_holding_graphs(card, kind):
    """In a process of its own: inside a capture, finished graphs become
    garbage held in a reference cycle (the captured function builds it and
    drops it), with the collector set to run at every allocation. A
    collection there would destroy those graphs while the stream captures and
    invalidate the capture; captures pause the collector."""
    code = ("import gc, torch\n"
            "from diffusestylegesture_torch.utils.graphs import CapturedStep, GraphSet\n"
            "x = torch.zeros(256, device='cuda')\n"
            "old = [GraphSet(x.device).capture(lambda: x.add_(1))[0] for _ in range(4)]\n"
            "calls = [0]\n"
            "gc.set_threshold(1, 1, 1)\n"
            "def step():\n"
            "    calls[0] += 1\n"
            "    if calls[0] == 2:  # the capture (the first call is the eager warm-up)\n"
            "        cycle = [old.pop() for _ in range(4)]\n"
            "        cycle.append(cycle)\n"
            "        del cycle\n"
            "    parts = [x * k for k in range(8)]  # Python objects allocated while capturing\n"
            "    x.copy_(sum(parts) / 28)\n"
            "    return {'x': x.sum()}\n"
            f"if {kind!r} == 'graph_set':\n"
            "    g, _ = GraphSet(x.device).capture(step)\n"
            "    g.replay(3)\n"
            "else:\n"
            "    CapturedStep(step, x.device)(3)\n"
            "torch.cuda.synchronize()\n"
            "assert calls[0] == 2 and not old\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# ---- captured training-style steps ----------------------------------------------------


def _train_setup(dev, bf16=False, seed=0, **cfg_kw):
    """A fresh train state, the device-cache step and its generator, windows on the card."""
    from diffusestylegesture_torch.data.device_cache import make_device_data_train_step
    from diffusestylegesture_torch.train import TrainConfig, TrainState, make_zeggs_cond_builder

    torch.manual_seed(seed)
    model = MDM(MDMConfig(njoints=NJ, latent_dim=128, ff_size=256, num_layers=2,
                          audio_in_dim=32, impl="plain")).to(dev)
    cfg = TrainConfig(lr=1e-3, ema_rate=0.99, compute_dtype="bfloat16" if bf16 else "float32",
                      **cfg_kw)
    rng = np.random.default_rng(seed)
    arrays = {"motion": torch.as_tensor(rng.standard_normal((16, 88, NJ)), dtype=torch.float32,
                                        device=dev),
              "style": torch.eye(6, device=dev)[torch.as_tensor(rng.integers(0, 6, 16))],
              "wavlm": torch.as_tensor(rng.standard_normal((16, 88, 32)), dtype=torch.float32,
                                       device=dev)}
    sched = D.Schedule.create(D.named_beta_schedule("cosine", 20), device=dev)
    step = make_device_data_train_step(sched, cfg, make_zeggs_cond_builder(8), batch_size=4)
    return (TrainState(model, cfg, 20), step, torch.Generator(device=dev).manual_seed(1), arrays)


def _assert_states_equal(a, b):
    for name in ("data", "grad"):
        assert torch.equal(getattr(a.params, name), getattr(b.params, name)), name
    for name in ("mu", "nu", "count"):
        assert torch.equal(getattr(a.optimizer, name), getattr(b.optimizer, name)), name
    assert a.ema is None or torch.equal(a.ema, b.ema)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16,cfg_kw", [
    (False, {}), (True, {}),
    (False, dict(schedule_sampler="loss-second-moment", skip_nonfinite_updates=2))],
    ids=["f32", "bf16", "f32-loss-aware-skip-nonfinite"])
def test_cuda_captured_train_step_equals_eager(card, bf16, cfg_kw):
    """Three device-cache train steps (batch gather, forward with dropout and
    condition drop, backward, AdamW, EMA; the loss-aware history and the
    non-finite skip in one case): captured (one eager first step, two replays)
    and eager, bitwise equal, and the generators end equal."""
    dev = card["dev"]
    eager, step, gen_e, arrays = _train_setup(dev, bf16, **cfg_kw)
    captured, _, gen_c, _ = _train_setup(dev, bf16, **cfg_kw)
    run = graphs.CapturedStep(lambda: step.device_step(captured, gen_c, arrays), dev, [gen_c])
    for _ in range(3):
        m_e = step(eager, gen_e, arrays)
        m_c = run()
    torch.cuda.synchronize()
    _assert_states_equal(eager, captured)
    assert all(torch.equal(m_e[k], m_c[k]) for k in m_e)
    assert torch.equal(gen_e.get_state(), gen_c.get_state())
    assert int(captured.optimizer.count) == 3 and run.graph is not None
    if eager.loss_aware is not None:
        assert torch.equal(eager.loss_aware.history, captured.loss_aware.history)
        assert torch.equal(eager.loss_aware.counts, captured.loss_aware.counts)


@pytest.mark.cuda
def test_cuda_captured_distillation_step_equals_eager(card):
    """Three distillation steps, the teacher through kernels A and B: captured
    and eager bitwise equal; each replay counts the teacher's launches."""
    from diffusestylegesture_torch.cli.distill import make_stage_step
    from diffusestylegesture_torch.data.device_cache import DeviceWindowCache
    from diffusestylegesture_torch.train import make_zeggs_cond_builder

    dev = card["dev"]
    sched = D.Schedule.create(D.named_beta_schedule("cosine", 20), device=dev)
    _, _, _, arrays = _train_setup(dev)
    cache = DeviceWindowCache({k: v.cpu().numpy() for k, v in arrays.items()}, dev)

    def stage():
        torch.manual_seed(0)
        kw = dict(njoints=NJ, latent_dim=128, ff_size=256, num_layers=2, audio_in_dim=32)
        teacher = MDM(MDMConfig(**kw)).to(dev).eval()
        student = MDM(MDMConfig(**kw, impl="plain")).to(dev)
        student.load_state_dict(teacher.state_dict())
        gen = torch.Generator(device=dev).manual_seed(3)
        state, step = make_stage_step(student, teacher, sched, cache, make_zeggs_cond_builder(8),
                                      4, 1e-4, gen)
        return state, step, gen

    eager, step_e, gen_e = stage()
    captured, step_c, gen_c = stage()
    run = graphs.CapturedStep(step_c, dev, [gen_c])
    for i in range(3):
        before = graphs.launch_counts()
        loss_e = step_e()["loss"]
        mid = graphs.launch_counts()
        loss_c = run()["loss"]
        after = graphs.launch_counts()
        eager_counts = tuple(b - a for a, b in zip(before, mid))
        assert eager_counts[:3] == (2, 4, 0)  # 2 teacher calls
        assert tuple(b - a for a, b in zip(mid, after)) == eager_counts, i
        assert torch.equal(loss_e, loss_c)
    torch.cuda.synchronize()
    _assert_states_equal(eager, captured)
    assert torch.equal(gen_e.get_state(), gen_c.get_state())


@pytest.mark.cuda
def test_cuda_captured_autoencoder_step_equals_eager(card):
    from diffusestylegesture_torch.eval.embedding import (AEConfig, GestureAutoencoder,
                                                          make_autoencoder_step)
    from diffusestylegesture_torch.train import TrainConfig, TrainState

    dev = card["dev"]
    data = torch.randn(64, 40, NJ, generator=torch.Generator().manual_seed(0)).to(dev)

    def setup():
        torch.manual_seed(0)
        state = TrainState(GestureAutoencoder(AEConfig(feat_dim=NJ, hidden=32, latent=16)).to(dev),
                           TrainConfig(lr=1e-3))
        return state, make_autoencoder_step(state, data, 8), torch.Generator(dev).manual_seed(2)

    eager, step_e, gen_e = setup()
    captured, step_c, gen_c = setup()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        run = graphs.CapturedStep(lambda: step_c(gen_c), dev, [gen_c])
        for _ in range(3):
            loss_e = step_e(gen_e)["loss"]
            loss_c = run()["loss"]
            assert torch.equal(loss_e, loss_c)
    torch.cuda.synchronize()
    _assert_states_equal(eager, captured)


@pytest.mark.cuda
def test_cuda_failed_step_capture_raises(card):
    """In a process of its own, as `test_cuda_failed_capture_raises`: a step that
    reads a value on the host cannot be captured."""
    code = ("import torch\n"
            "from diffusestylegesture_torch.utils.graphs import CapturedStep\n"
            "x = torch.ones(4, device='cuda')\n"
            "step = CapturedStep(lambda: {'loss': x * x.sum().item()}, x.device)\n"
            "try:\n"
            "    step()  # the eager first step runs, then its capture raises\n"
            "except RuntimeError:\n"
            "    raise SystemExit(0)\n"
            "raise SystemExit('the capture did not raise')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# ---- the BEAT/TWH engine ------------------------------------------------------------


def _beat_both(card, variant, guidance=0.0, seed_lasts=(None,)):
    """Graph, eager and per-step eager (`PerStep`) poses of a small MDMPlus
    (njoints 72, latent 128, 2 layers) over 3 windows, dpmpp5, one call a
    seed_last; with the launch counts."""
    dev = card["dev"]
    torch.manual_seed(0)
    mcfg = MDMPlusConfig(njoints=72, latent_dim=128, ff_size=256, num_layers=2,
                         source_audio_dim=40, audio_feat_dim=32, style_dim_in=4,
                         cond_mode=f"cross_local_attention{variant[-1]}_style1")
    model = MDMPlus(mcfg).to(dev).eval()
    rng = np.random.default_rng(3)
    textaudio = rng.standard_normal((300, 40)).astype(np.float32)
    seed = rng.standard_normal((30, 72)).astype(np.float32)
    stats = (np.zeros(24, np.float32), np.ones(24, np.float32))
    betas = D.named_beta_schedule("cosine", 1000)
    sched = D.spaced_schedule(betas, D.space_timesteps(1000, "ddim5"), device=dev)
    out = {}
    for path, flag in (("graph", None), ("eager", False), ("per_step", False)):
        s = BeatTwhSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond), sched,
                           BeatEngineConfig(njoints=72, audio_dim=40, variant=variant,
                                            sampler="dpmpp",
                                            guidance_scale=guidance),
                           device=dev, graphs=flag)
        poses = []
        before = graphs.launch_counts()
        for seed_last in seed_lasts:
            gen = torch.Generator(device=dev).manual_seed(5)
            poses.append(s.generate(PerStep(model) if path == "per_step" else model,
                                    textaudio, seed, np.eye(4, dtype=np.float32)[[2]],
                                    gen, *stats, seed_last=seed_last))
        counts = tuple(b - a for a, b in zip(before, graphs.launch_counts()))
        out[path] = (poses, counts, s)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("guidance", [0.0, 1.5], ids=["plain", "cfg"])
@pytest.mark.parametrize("variant", ["attention3", "attention4"])
def test_cuda_beat_graph_equals_eager(card, variant, guidance):
    out = _beat_both(card, variant, guidance)
    (g, gc, gs), (e, ec, es), (p, pc, _) = out["graph"], out["eager"], out["per_step"]
    assert gs.graphs and not es.graphs and gs.capture_seconds > 0
    assert g[0].shape == (1, 300, 24) and np.isfinite(g[0]).all()
    assert np.array_equal(g[0], e[0]) and np.array_equal(g[0], p[0])
    assert gc == ec == pc and gc[:3] == (3 * 5, 2 * 3 * 5, 0)
    assert gs.cond_encodes == (0 if guidance else 3)


@pytest.mark.cuda
def test_cuda_beat_graph_reads_each_seed_last(card):
    rng = np.random.default_rng(4)
    lasts = tuple(rng.standard_normal((30, 72)).astype(np.float32) for _ in range(2))
    out = _beat_both(card, "attention5", seed_lasts=lasts)
    g, e, p = out["graph"][0], out["eager"][0], out["per_step"][0]
    assert all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(g, e, p))
    assert np.abs(g[0] - g[1]).max() > 1e-3  # the second call's seed_last reached the graph
    assert out["graph"][2].capture_seconds > 0 and len(out["graph"][2]._runs) == 1
