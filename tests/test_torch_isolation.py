"""The PyTorch port stands alone: no JAX, CUDA by default, CPU on request.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_isolation.py

There the `cuda` tests hold each CUDA kernel against its plain PyTorch
version (local attention atol 1e-5, at the ZEGGS, BEAT and TWH shapes and odd
ones, aliased and distinct q/k/v, packed and strided-in / merged-out; encoder layer atol 1e-4 in float32,
where the kernel's 3xTF32 products sum in another order, and 1e-2 in the
`mxu_bf16` mode, where a sum in another order can round an operand to the
other bf16 neighbour) and check the launch counters; elsewhere they skip.
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

import chip_smoke
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
        "new = {'diffusestylegesture_torch.audio.loudness', 'diffusestylegesture_torch.utils.graphs'}\n"
        "print(len(mods), bad, sorted(new - set(mods)))\n"
        "sys.exit(1 if bad or len(mods) < 24 or not new <= set(mods) else 0)\n")
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


@pytest.mark.parametrize("extra", [[], ["--sampler", "dpmpp", "--respace", "2"],
                                   ["--sampler", "dpmpp", "--respace", "2", "--serve_fast"],
                                   ["--normalize_loudness", "--use_ema"]],
                         ids=["ddpm", "dpmpp", "serve_fast", "loudness"])
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


# (N, w, D) at 8 heads: the ZEGGS, BEAT and TWH denoisers' shapes, an odd one on
# the scalar path (D % 4 != 0), one with two keys a lane (2w > 32), the largest
LOCAL_ATTENTION_SHAPES = [*chip_smoke.LOCAL_ATTENTION_SHAPES.values(), (40, 5, 30), (80, 20, 64),
                          (64, 32, 128)]


def local_attention_case(device, shape, b, masked, aliased, layout, heads=8):
    """(q, k, v, mask, out, packed q/k/v): `layout` "packed" is contiguous
    (B·H, N, D) tensors and a new output; "merged" is the (B, H, N, D) view of
    (B, N, H·D) activations, with `out` such a view too."""
    n, w, d = shape
    g = torch.Generator().manual_seed(1000 * b + n + d)
    base = [torch.randn(b, n, heads * d, generator=g).to(device) for _ in range(3)]
    if aliased:
        base = [base[0]] * 3
    views = [t.view(b, n, heads, d).transpose(1, 2) for t in base]
    packed = [t.reshape(b * heads, n, d) for t in views]
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    if masked == "partial":
        mask[-1, -7:] = False
        mask[0, 3] = False
    elif masked == "row":
        mask[0] = False  # every key of batch element 0: its rows are uniform averages
    elif masked == "none":
        mask = None
    if layout == "packed":
        if aliased:
            packed = [packed[0]] * 3
        return packed, mask, None, packed
    out = torch.full((b, n, heads * d), float("nan"), device=device)
    return views, mask, out.view(b, n, heads, d).transpose(1, 2), packed


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "merged"])
@pytest.mark.parametrize("aliased", [True, False], ids=["aliased", "distinct"])
@pytest.mark.parametrize("masked", ["all", "partial", "none", "row"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("shape", LOCAL_ATTENTION_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_local_attention_matches_plain(cuda_device, shape, b, masked, aliased, layout):
    w = shape[1]
    qkv, mask, out, packed = local_attention_case(cuda_device, shape, b, masked, aliased, layout)
    before = ops_local_attention.launches
    res = ops_local_attention.local_attention(*qkv, w, mask, heads=8, out=out)
    torch.cuda.synchronize()
    assert ops_local_attention.launches == before + 1
    ref = local_attention_plain(*packed, w, mask, heads=8)
    if out is not None:
        assert res is out
        res = res.reshape(ref.shape)  # the merged buffer, read back packed
    assert res.shape == ref.shape
    assert (res - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LOCAL_ATTENTION_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("aliased,layout", [(False, "packed"), (True, "merged")],
                         ids=["distinct-packed", "aliased-merged"])
def test_cuda_local_attention_is_deterministic(cuda_device, shape, aliased, layout):
    qkv, mask, out, _ = local_attention_case(cuda_device, shape, 2, "partial", aliased, layout)
    first = ops_local_attention.local_attention(*qkv, shape[1], mask, heads=8, out=out).clone()
    if out is not None:
        out.fill_(float("nan"))
    second = ops_local_attention.local_attention(*qkv, shape[1], mask, heads=8, out=out)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_local_attention_rejects_shapes_beyond_its_limits(cuda_device):
    before = ops_local_attention.launches
    wide = torch.randn(8, 22, ops_local_attention.MAX_DIM + 4, device=cuda_device)
    with pytest.raises(ValueError, match=f"head dim .* {ops_local_attention.MAX_DIM}"):
        ops_local_attention.local_attention(wide, wide, wide, 11, heads=8)
    long = torch.randn(8, 66, 32, device=cuda_device)
    with pytest.raises(ValueError, match=f"window 33 .* {ops_local_attention.MAX_WINDOW}"):
        ops_local_attention.local_attention(long, long, long, 33, heads=8)
    with pytest.raises(ValueError, match="divide N=66"):
        ops_local_attention.local_attention(long, long, long, 12, heads=8)
    with pytest.raises(ValueError, match="mask must be a contiguous bool"):
        ops_local_attention.local_attention(
            long, long, long, 11, torch.ones(1, 66, dtype=torch.uint8, device=cuda_device), heads=8)
    assert ops_local_attention.launches == before


# the denoiser's shapes (B = 2 under CFG), BEAT's / TWH's trunk widths and the
# widest layer the wrapper takes (head dim 256)
ENCODER_SHAPES = [(1, 89, 256), (2, 89, 256), (1, 151, 384), (1, 151, 512), (1, 89, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ENCODER_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "relu"])
def test_cuda_encoder_layer_matches_plain(cuda_device, activation, shape, mxu_bf16):
    torch.manual_seed(0)
    B, T, D = shape
    layer = TorchEncoderLayer(D, 4, 1024, activation).to(cuda_device).eval()
    x = torch.randn(B, T, D, device=cuda_device)
    before = (ops_encoder_layer.launches, ops_encoder_layer.launches_bf16)
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(x, layer, mxu_bf16=mxu_bf16)
        torch.cuda.synchronize()
        ref = layer(x, mxu_bf16=mxu_bf16)
    after = (ops_encoder_layer.launches, ops_encoder_layer.launches_bf16)
    assert after == (before[0] + (not mxu_bf16), before[1] + mxu_bf16)
    assert (out - ref).abs().max().item() <= (1e-2 if mxu_bf16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_encoder_layer_is_deterministic(cuda_device, mxu_bf16):
    torch.manual_seed(0)
    layer = TorchEncoderLayer(256, 4, 1024).to(cuda_device).eval()
    x = torch.randn(2, 89, 256, device=cuda_device)
    with torch.no_grad():
        first = ops_encoder_layer.encoder_layer(x, layer, mxu_bf16=mxu_bf16)
        second = ops_encoder_layer.encoder_layer(x, layer, mxu_bf16=mxu_bf16)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_encoder_layer_rejects_what_shared_memory_cannot_hold(cuda_device):
    # the attention grid holds all keys of a head: at head dim 64, T 336 is the most
    layer = TorchEncoderLayer(256, 4, 1024).to(cuda_device).eval()
    before = ops_encoder_layer.launches
    with torch.no_grad():
        ops_encoder_layer.encoder_layer(torch.randn(1, 336, 256, device=cuda_device), layer)
        with pytest.raises(ValueError, match="shared memory"):
            ops_encoder_layer.encoder_layer(torch.randn(1, 400, 256, device=cuda_device), layer)
    assert ops_encoder_layer.launches == before + 1


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
