"""The serving surfaces and the ZeroEGGS rollout on the card.

Imports neither jax nor the JAX package, so it runs on a machine with a card
and no JAX (skip the conftest there, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_serving_cuda.py

On the card: the `GestureServer` at max_batch 16 through kernels A and B
(CUDA graphs captured on its dispatcher thread) equals the same server on
the plain path within 2e-3 relative, and the kernels were launched; a ZEGGS
stream over 0.5 s pushes is within 2e-3 relative of the batch engine; a
capture made on a thread other than the main one survives cyclic garbage
that holds finished graphs (the collector is paused there too); the
ZeroEGGS rollout step replayed as a CUDA graph equals its eager run bitwise.
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
from diffusestylegesture_torch.sample import (GestureServer, ServerConfig, ZeggsEngineConfig,
                                              ZeggsSampler, ZeggsStreamSampler)
from diffusestylegesture_torch.utils import graphs

from test_torch_isolation import TINY_WAVLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NJ = 64


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    models = {}
    for impl in ("kernel", "plain"):
        mdm = MDM(MDMConfig(njoints=NJ, latent_dim=128, ff_size=256, num_layers=2,
                            audio_in_dim=32, impl=impl))
        if models:
            mdm.load_state_dict(models["kernel"].state_dict())
        models[impl] = mdm.to(dev).eval()
    wavlm = WavLM(WavLMConfig(**TINY_WAVLM)).to(dev).eval()
    rng = np.random.default_rng(0)
    audios = [(rng.standard_normal(w * 64000 + 300) * 0.1).astype(np.float32)
              for w in (1, 2, 2, 1, 2)]
    return dict(dev=dev, models=models, wavlm=wavlm, audios=audios)


def _sampler(dev, sampler="dpmpp", steps=5):
    betas = D.named_beta_schedule("cosine", 1000)
    sched = D.spaced_schedule(betas, D.space_timesteps(1000, f"ddim{steps}"), device=dev)
    return ZeggsSampler(lambda m, x, t, c, uncond=None: m(x, t, c, uncond=uncond),
                        make_zeggs_wavlm_fn(88), sched,
                        ZeggsEngineConfig(njoints=NJ, sampler=sampler, crossfade_n=1), device=dev)


def _rel(out, ref):
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).mean()), 1.0)


@pytest.mark.cuda
def test_cuda_server_kernel_path_matches_plain_path(card):
    outs = {}
    for impl in ("kernel", "plain"):
        server = GestureServer(_sampler(card["dev"]), card["models"][impl], card["wavlm"],
                               cfg=ServerConfig(max_batch=16, max_delay_ms=500.0,
                                                window_buckets=(2,)), seed=1)
        before = graphs.launch_counts()
        server.start()
        try:
            futs = [server.submit(a, np.eye(6, dtype=np.float32)[i % 6])
                    for i, a in enumerate(card["audios"])]
            outs[impl] = [f.result(timeout=600) for f in futs]
        finally:
            server.stop()
        launched = tuple(b - a for a, b in zip(before, graphs.launch_counts()))
        assert server.batches_served == 1
        if impl == "kernel":
            assert launched[0] > 0 and launched[1] > 0
        else:
            assert launched == (0, 0, 0)
    for k, p in zip(outs["kernel"], outs["plain"]):
        assert k.shape == p.shape and np.isfinite(k).all()
        assert _rel(k, p) < 2e-3


@pytest.mark.cuda
def test_cuda_stream_matches_batch_engine(card):
    sampler = _sampler(card["dev"])
    mdm = card["models"]["kernel"]
    audio = card["audios"][1]
    style = np.eye(6, dtype=np.float32)[[2]]
    ref = sampler.generate(mdm, card["wavlm"], audio, style,
                           torch.Generator(device=card["dev"]).manual_seed(3))
    stream = ZeggsStreamSampler(sampler, mdm, card["wavlm"], style,
                                torch.Generator(device=card["dev"]).manual_seed(3))
    out = []
    for i in range(0, len(audio), 8000):
        out += stream.push(audio[i: i + 8000])
    got = np.concatenate(out, 1)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 2e-3


@pytest.mark.cuda
def test_cuda_capture_on_another_thread_survives_cyclic_garbage(card):
    """As tests/test_torch_graphs.py's main-thread case, from a worker thread
    (the server's dispatcher captures there)."""
    code = ("import gc, threading, torch\n"
            "from diffusestylegesture_torch.utils.graphs import GraphSet\n"
            "x = torch.zeros(256, device='cuda')\n"
            "old = [GraphSet(x.device).capture(lambda: x.add_(1))[0] for _ in range(4)]\n"
            "calls, errors = [0], []\n"
            "gc.set_threshold(1, 1, 1)\n"
            "def step():\n"
            "    calls[0] += 1\n"
            "    if calls[0] == 2:  # the capture (the first call is the eager warm-up)\n"
            "        cycle = [old.pop() for _ in range(4)]\n"
            "        cycle.append(cycle)\n"
            "        del cycle\n"
            "    parts = [x * k for k in range(8)]\n"
            "    x.copy_(sum(parts) / 28)\n"
            "def worker():\n"
            "    try:\n"
            "        g, _ = GraphSet(x.device).capture(step)\n"
            "        g.replay(3)\n"
            "        torch.cuda.synchronize()\n"
            "    except Exception as e:\n"
            "        errors.append(e)\n"
            "t = threading.Thread(target=worker)\n"
            "t.start(); t.join()\n"
            "assert not errors, errors\n"
            "assert calls[0] == 2 and not old and gc.isenabled()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.cuda
def test_cuda_zeroeggs_captured_rollout_equals_eager(card):
    from diffusestylegesture_torch.models.zeroeggs import ZeroEGGS, ZeroEGGSConfig
    from diffusestylegesture_torch.sample.engine_zeroeggs import ZeroEggsGenerator

    torch.manual_seed(0)
    model = ZeroEGGS(ZeroEGGSConfig(hidden_size=64, speech_encoding_size=16,
                                    style_embedding_size=8), 81)
    rng = np.random.default_rng(1)
    stats = {"audio_input_mean": np.zeros(81, np.float32),
             "audio_input_std": np.ones(81, np.float32),
             "anim_input_mean": np.zeros(1134, np.float32),
             "anim_input_std": np.ones(1134, np.float32),
             "anim_output_mean": np.zeros(1131, np.float32),
             "anim_output_std": np.full(1131, 0.1, np.float32)}
    q = rng.standard_normal(4).astype(np.float32)
    first = (np.zeros(3, np.float32), q / np.linalg.norm(q), np.zeros(3, np.float32),
             np.zeros(3, np.float32), rng.standard_normal((75, 3)).astype(np.float32),
             rng.standard_normal((75, 2, 3)).astype(np.float32),
             np.zeros((75, 3), np.float32), np.zeros((75, 3), np.float32))
    af = rng.standard_normal((200, 81)).astype(np.float32)
    example = rng.standard_normal((60, 1134)).astype(np.float32)
    outs = {}
    for flag in (None, False):
        gen = ZeroEggsGenerator(model, stats, device=card["dev"], graphs=flag)
        style = gen.encode_style(example)
        outs[flag] = [t.cpu() for t in gen.generate(af, [style], first)]
        if flag is None:
            assert gen.capture_seconds > 0
    for a, b in zip(outs[None], outs[False]):
        assert torch.equal(a, b)
