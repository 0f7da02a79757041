"""The PyTorch port stands alone: no JAX, CUDA by default, CPU on request.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_isolation.py

There the `cuda` tests hold each CUDA kernel against its plain PyTorch
version (local attention atol 1e-5; encoder layer atol 1e-4, float32 sums
in another order) and check the launch counters; elsewhere they skip.
"""
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import diffusestylegesture_torch
from diffusestylegesture_torch import resolve_device
from diffusestylegesture_torch.models.local_attention import local_attention_plain
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.models.transformer import TorchEncoderLayer
from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig
from diffusestylegesture_torch.ops import encoder_layer as ops_encoder_layer
from diffusestylegesture_torch.ops import local_attention as ops_local_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_WAVLM = dict(
    encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=48,
    encoder_attention_heads=4, conv_pos=8, conv_pos_groups=4, num_buckets=40,
    max_distance=80,
    conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                         (16, 2, 2), (16, 2, 2)),
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return resolve_device("cuda")


def test_package_imports_no_jax_in_a_fresh_interpreter():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusestylegesture_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'diffusestylegesture_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()  # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    from diffusestylegesture_torch.diffusion import Schedule, named_beta_schedule

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Schedule.create(named_beta_schedule("cosine", 10))


def _wavlm_reference_state_dict(model: WavLM) -> dict:
    """The port's WavLM weights in the reference checkpoint layout: the
    pos-conv weight split into weight norm g/v (dim 2)."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.weight_v"] = w
    return sd


def write_tiny_run(tmp_path, diffusion_steps=4, seconds=8):
    """Seeded tiny checkpoints in reference layout, stats, a wav and a yaml."""
    torch.manual_seed(0)
    mcfg = MDMConfig(latent_dim=96, ff_size=64, num_layers=1, audio_in_dim=32)
    mdm_pt = str(tmp_path / "model.pt")
    torch.save(MDM(mcfg).state_dict(), mdm_pt)
    wcfg = WavLMConfig(**TINY_WAVLM)
    wavlm_pt = str(tmp_path / "WavLM-Tiny.pt")
    cfg_dict = {k: getattr(wcfg, k) for k in TINY_WAVLM}
    cfg_dict["conv_feature_layers"] = repr([tuple(t) for t in wcfg.conv_feature_layers])
    torch.save({"cfg": cfg_dict, "model": _wavlm_reference_state_dict(WavLM(wcfg))}, wavlm_pt)

    rng = np.random.default_rng(5)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    np.savez(data_dir / "mean.npz", mean=rng.standard_normal(1141).astype(np.float32))
    np.savez(data_dir / "std.npz", std=(0.5 + rng.random(1141)).astype(np.float32))
    from scipy.io import wavfile

    wav = str(tmp_path / "015_Happy_4_x_1_0.wav")
    wavfile.write(wav, 16000, (rng.standard_normal(16000 * seconds) * 1000).astype(np.int16))
    cfg = dict(njoints=1141, latent_dim=96, ff_size=64, num_layers=1, n_seed=8,
               cond_mode="cross_local_attention3_style1", cond_mask_prob=0.1,
               audio_feat="wavlm", wavlm_path=wavlm_pt, noise_schedule="cosine",
               diffusion_steps=diffusion_steps, n_poses=88, motion_resampling_framerate=20,
               data_dir=str(data_dir))
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_path, mdm_pt, wav


@pytest.mark.parametrize("extra", [[], ["--sampler", "dpmpp", "--respace", "2"]],
                         ids=["ddpm", "dpmpp"])
def test_cli_writes_bvh_on_cpu(tmp_path, extra):
    from diffusestylegesture_torch.cli import sample as sample_cli

    cfg_path, mdm_pt, wav = write_tiny_run(tmp_path)
    res = sample_cli.main(["--config", cfg_path, "--model_path", mdm_pt,
                           "--audiowavlm_path", wav, "--save_dir", str(tmp_path / "out"),
                           "--seed", "7", "--device", "cpu"] + extra)
    assert len(res["paths"]) == 1 and os.path.getsize(res["paths"][0]) > 0
    # 8 s of audio → 2 windows → 2·80 − 8 frames
    assert res["poses"].shape == (1, 152, 1141)
    assert np.isfinite(res["poses"]).all()
    with open(res["paths"][0]) as f:
        text = f.read()
    assert "Frames: 456" in text  # ×3 frame repetition to 60 fps


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    from diffusestylegesture_torch.cli import sample as sample_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        sample_cli.main(["--config", "unused.yml", "--model_path", "m.pt",
                         "--audiowavlm_path", "a.wav"])


# ---- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,masked", [(1, "all"), (2, "partial"), (1, "none")])
def test_cuda_local_attention_matches_plain(cuda_device, b, masked):
    g = torch.Generator().manual_seed(b)
    q, k, v = (torch.randn(b * 8, 88, 32, generator=g).to(cuda_device) for _ in range(3))
    mask = torch.ones(b, 88, dtype=torch.bool, device=cuda_device)
    if masked == "partial":
        mask[-1, -7:] = False
    mask = None if masked == "none" else mask
    before = ops_local_attention.launches
    out = ops_local_attention.local_attention(q, k, v, 11, mask, heads=8)
    torch.cuda.synchronize()
    assert ops_local_attention.launches == before + 1
    ref = local_attention_plain(q, k, v, 11, mask, heads=8)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "relu"])
def test_cuda_encoder_layer_matches_plain(cuda_device, activation):
    torch.manual_seed(0)
    layer = TorchEncoderLayer(256, 4, 1024, activation).to(cuda_device).eval()
    x = torch.randn(2, 89, 256, device=cuda_device)
    before = ops_encoder_layer.launches
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(x, layer)
        torch.cuda.synchronize()
        ref = layer(x)
    assert ops_encoder_layer.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_mdm_kernel_path_matches_plain_path(cuda_device):
    torch.manual_seed(0)
    cfg = MDMConfig(njoints=64, latent_dim=128, ff_size=256, num_layers=2)
    model = MDM(cfg).to(cuda_device).eval()
    plain = MDM(MDMConfig(**{**cfg.__dict__, "impl": "plain"})).to(cuda_device).eval()
    plain.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 1, 88, generator=g).to(cuda_device)
    cond = {"style": torch.eye(6)[:2].to(cuda_device),
            "seed": torch.randn(2, 64, 1, 8, generator=g).to(cuda_device),
            "audio": torch.randn(2, 88, 1024, generator=g).to(cuda_device),
            "mask_local": torch.ones(2, 88, dtype=torch.bool, device=cuda_device)}
    t = torch.tensor([999, 3], device=cuda_device)
    la0, el0 = ops_local_attention.launches, ops_encoder_layer.launches
    with torch.no_grad():
        out = model(x, t, cond)
        ref = plain(x, t, cond)
    assert (ops_local_attention.launches - la0, ops_encoder_layer.launches - el0) == (1, 2)
    assert (out - ref).abs().max().item() <= 1e-4
