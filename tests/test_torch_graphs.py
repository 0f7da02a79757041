"""The engine's CUDA graphs against its eager loop, on the card.

Imports neither jax nor the JAX package, so it runs on a machine with a card
and no JAX (there, skip the conftest, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_graphs.py

On the same inputs and generator seed, the graph path (`ZeggsSampler` on
CUDA) and the eager comparison path (`graphs=False`) give bitwise-equal poses
for every sampler, with and without classifier-free guidance, and for
`generate_multi_clip`; the generator ends in the same state; the launch
counters read the same after replays as after eager calls; a capture that
fails raises; `--serve_fast` stays within the bench gate's 2e-2 of float32.
Elsewhere every test skips.
"""
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
from diffusestylegesture_torch.sample import ZeggsEngineConfig, ZeggsSampler, generate_multi_clip
from diffusestylegesture_torch.utils import graphs

from test_torch_isolation import TINY_WAVLM

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
    """(graph poses, eager poses, launch counts of each, final generator states)."""
    mdm, wavlm = card["models"][model]
    style = np.eye(6, dtype=np.float32)[list(styles)]
    out = {}
    for path, flag in (("graph", None), ("eager", False)):
        s = _sampler(card["dev"], sampler, steps, guidance, graphs_on=flag)
        gen = torch.Generator(device=card["dev"]).manual_seed(42)
        before = graphs.launch_counts()
        poses = s.generate(mdm, wavlm, card["audio"], style, gen)
        counts = tuple(b - a for a, b in zip(before, graphs.launch_counts()))
        out[path] = (poses, counts, gen.get_state(), s)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("guidance", [0.0, 1.5], ids=["plain", "cfg"])
@pytest.mark.parametrize("sampler,steps", [("ddpm", 10), ("ddim", 10), ("plms", 10),
                                           ("dpmpp", 5)])
def test_cuda_graph_equals_eager(card, sampler, steps, guidance):
    out = _both(card, sampler, steps, guidance)
    g, e = out["graph"], out["eager"]
    assert g[3].graphs and not e[3].graphs and g[3].capture_seconds > 0
    assert np.isfinite(g[0]).all() and g[0].shape == (1, 3 * 80 - 8, NJ)
    assert np.array_equal(g[0], e[0])
    assert torch.equal(g[2], e[2])  # the generator advanced alike
    calls = 3 * (steps + (1 if sampler == "plms" else 0))
    assert g[1] == e[1] == (calls, 2 * calls, 0)


@pytest.mark.cuda
def test_cuda_graph_equals_eager_ddpm1000_batched(card):
    out = _both(card, "ddpm", 1000, styles=(0, 4))
    assert np.array_equal(out["graph"][0], out["eager"][0])
    assert out["graph"][1] == out["eager"][1] == (3000, 6000, 0)


@pytest.mark.cuda
def test_cuda_graph_equals_eager_multi_clip(card):
    mdm, wavlm = card["models"]["f32"]
    audios = [card["audio"], card["audio"][: 80 * 800 + 100], card["audio"][:9000]]
    styles = np.eye(6, dtype=np.float32)[[1, 2, 3]]
    res = {}
    for path, flag in (("graph", None), ("eager", False)):
        gen = torch.Generator(device=card["dev"]).manual_seed(7)
        res[path] = generate_multi_clip(_sampler(card["dev"], "dpmpp", 5, graphs_on=flag), mdm,
                                        wavlm, audios, styles, gen)
    assert [r.shape for r in res["graph"]] == [(232, NJ), (72, NJ), (0, NJ)]
    for a, b in zip(res["graph"], res["eager"]):
        assert np.array_equal(a, b)


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
    assert res["bf16"][1] == (15, 0, 30)  # kernel B in its bf16 mode only
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
