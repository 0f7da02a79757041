"""The PyTorch port stands alone: no JAX, CUDA by default, CPU on request.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_isolation.py

There the `cuda` tests hold each CUDA kernel against its plain PyTorch
version (local attention atol 1e-5, at the ZEGGS, BEAT and TWH shapes and odd
ones, aliased and distinct q/k/v, packed and strided-in / merged-out; encoder
layer atol 1e-4 in float32, where the kernel's 3xTF32 products sum in another
order, and 1e-2 in the `mxu_bf16` mode, where a sum in another order can round
an operand to the other bf16 neighbour), the BEAT/TWH denoiser's kernel path
against its plain path at the published widths for each variant (1e-4), and
check the launch counters, also at the distillation teacher's batch of 300
and, given two cards, on the second card after the first (each kernel's
shared-memory opt-in is per device); the BEAT/TWH device-cache train step at
the full TWH width, captured as a CUDA graph, equals its eager step bitwise
and launches no kernel; elsewhere they skip.
"""
import ast
import functools
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
from diffusestylegesture_torch.models.mdm_plus import beat_mdm, twh_mdm
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
        "for m in mods + ['chip_smoke']: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'diffusestylegesture_tpu'))\n"
        "new = {'diffusestylegesture_torch.' + m for m in ('audio.loudness', 'utils.graphs', "
        "'audio.sphinx_mfcc', 'cli.prepare_data', 'cli.train', 'data.device_cache', "
        "'diffusion.resample', 'train.checkpoint', 'train.logger', 'train.loop', "
        "'train.state', 'audio.features', 'cli.distill', 'cli.eval', 'eval', "
        "'eval.embedding', 'eval.metrics', 'eval.unconstrained', 'train.distill', "
        "'audio.praat_pitch', 'data.text', 'data.beat_twh', 'models.mdm_plus', "
        "'sample.engine_beat', 'cli.sample_beat', 'motion.pipeline', 'motion.pipeline_extras', "
        "'data.bvh_repair', 'data.beat_proc', 'data.h5_loader', 'utils.precision', "
        "'utils.profiling', 'sample.edit', 'sample.restyle', 'sample.streaming', "
        "'sample.server', 'cli.serve', 'models.zeroeggs', 'sample.engine_zeroeggs', "
        "'data.zeroeggs_data', 'cli.zeroeggs', 'models.moe', 'models.tisa', "
        "'models.local_transformer', 'models.baselines', 'models.unet1d', 'models.diffwav', "
        "'utils.rotations', 'motion.humanml', 'models.clip_text', 'models.mdm_text', "
        "'cli.generate', 'data.humanml', 'cli.train_t2m', 'eval.t2m', 'eval.t2m_evaluator', "
        "'models.smpl', 'eval.stgcn', 'eval.action2motion', 'motion.gltf_export', "
        "'motion.viz', 'motion.mocap_player', 'cli.export_gltf', 'parallel', "
        "'parallel.comm', 'parallel.draws', 'parallel.fsdp', 'parallel.mesh', "
        "'parallel.multihost', 'parallel.pipeline', 'parallel.seq_parallel', 'parallel.tp', "
        "'sample.engine_t2m')}\n"
        "print(len(mods), bad, sorted(new - set(mods)), 'h5py' in sys.modules)\n"
        "sys.exit(1 if bad or len(mods) < 109 or not new <= set(mods) or 'h5py' in sys.modules "
        "else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # chip_smoke.py imports inside its phases too: none of them names JAX
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                for alias in node.names}
    imported |= {node.module for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
    assert not {m for m in imported if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "orbax", "diffusestylegesture_tpu")}


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()  # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from diffusestylegesture_torch.cli import serve as serve_cli
    from diffusestylegesture_torch.cli import zeroeggs as zeroeggs_cli
    from diffusestylegesture_torch.diffusion import Schedule, named_beta_schedule
    from diffusestylegesture_torch.models.zeroeggs import ZeroEGGS, ZeroEGGSConfig
    from diffusestylegesture_torch.sample import edit
    from diffusestylegesture_torch.sample.engine_zeroeggs import ZeroEggsGenerator
    from diffusestylegesture_torch.cli import generate as generate_cli
    from diffusestylegesture_torch.cli import train_t2m as train_t2m_cli
    from diffusestylegesture_torch.eval.stgcn import A2MEvaluation
    from diffusestylegesture_torch.eval.t2m_evaluator import T2MEvaluator
    from diffusestylegesture_torch.models.clip_text import make_caption_encoder
    from diffusestylegesture_torch.models.smpl import SmplModel
    from diffusestylegesture_torch.models.unet1d import make_generator_diff_schedule

    from diffusestylegesture_torch.cli import train as train_cli
    from diffusestylegesture_torch.parallel import make_mesh, multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Schedule.create(named_beta_schedule("cosine", 10))
    # the parallel slice: the process group, the serving mesh and a meshed
    # cli.train take the card unless the CPU is asked for (no group is made)
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.initialize()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--config", "c.yml", "--use_mesh", "--fsdp"])
    assert not torch.distributed.is_initialized()
    # the server, the streams, restyle_window and edit_motion run where their
    # sampler, schedule and model lie, which default to the card (above)
    for call in (lambda: edit.in_between_mask((1, 4, 1, 8), 2),
                 lambda: edit.feature_mask((1, 4, 1, 8), [0]),
                 lambda: ZeroEggsGenerator(ZeroEGGS(ZeroEGGSConfig(hidden_size=8), 4), {}),
                 lambda: serve_cli.main(["--config", "c.yml", "--model_path", "m.pt"]),
                 lambda: zeroeggs_cli.main(["train", "--data", str(tmp_path), "--save_dir",
                                            str(tmp_path)]),
                 lambda: zeroeggs_cli.main(["generate", "--network", str(tmp_path), "--stats",
                                            "s.npz", "--audio", "a.wav", "--style", "x.bvh"]),
                 lambda: make_generator_diff_schedule(10),
                 lambda: make_caption_encoder(width=8, layers=1, heads=2, vocab_size=16,
                                              projection_dim=4, context_length=4),
                 lambda: T2MEvaluator({}),
                 lambda: A2MEvaluation(None, 6, 12),
                 lambda: SmplModel.from_arrays(v_template=np.zeros((1, 3))),
                 lambda: generate_cli.main(["--model_path", str(tmp_path), "--text_prompt", "x"]),
                 lambda: train_t2m_cli.main(["--motion_dir", "m", "--text_dir", "t", "--split",
                                             "s", "--mean", "m", "--std", "s", "--save_dir",
                                             str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


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


def test_cpu_wrappers_keep_autograd():
    """On a CPU tensor the wrappers are the plain versions, autograd included."""
    torch.manual_seed(0)
    layer = TorchEncoderLayer(32, 4, 64)
    x = torch.randn(2, 9, 32, requires_grad=True)
    ops_encoder_layer.encoder_layer(x, layer).sum().backward()
    assert x.grad is not None and layer.linear1.weight.grad is not None
    q = torch.randn(16, 22, 8, requires_grad=True)
    ops_local_attention.local_attention(q, q, q, 11, heads=8).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


# ---- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_wrappers_refuse_autograd(cuda_device):
    """The kernels have no backward: given inputs that require grad with
    autograd on, the wrappers raise instead of returning a tensor without a
    gradient; under no_grad the same calls launch and match the plain version."""
    torch.manual_seed(0)
    layer = TorchEncoderLayer(256, 4, 1024).to(cuda_device)
    x = torch.randn(1, 89, 256, device=cuda_device)
    before = (ops_encoder_layer.launches, ops_local_attention.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        ops_encoder_layer.encoder_layer(x, layer)  # the layer's weights require grad
    layer.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        ops_encoder_layer.encoder_layer(x.clone().requires_grad_(), layer)
    q = torch.randn(8, 88, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops_local_attention.local_attention(q, q, q, 11, heads=8)
    assert (ops_encoder_layer.launches, ops_local_attention.launches) == before
    layer.requires_grad_(True)
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(x, layer)
        ref = layer(x)
        att = ops_local_attention.local_attention(q, q, q, 11, heads=8)
        att_ref = local_attention_plain(q, q, q, 11, heads=8)
    assert (out - ref).abs().max().item() <= 1e-4
    assert (att - att_ref).abs().max().item() <= 1e-5
    assert (ops_encoder_layer.launches, ops_local_attention.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    model = MDM(MDMConfig(njoints=64, latent_dim=128, ff_size=256, num_layers=1)).to(cuda_device)
    cond = {"style": torch.eye(6)[:1].to(cuda_device),
            "seed": torch.zeros(1, 64, 1, 8, device=cuda_device),
            "audio": torch.zeros(1, 88, 1024, device=cuda_device),
            "mask_local": torch.ones(1, 88, dtype=torch.bool, device=cuda_device)}
    with pytest.raises(RuntimeError, match="no backward"):
        model(torch.zeros(1, 64, 1, 88, device=cuda_device), torch.zeros(1, dtype=torch.long,
                                                                         device=cuda_device), cond)


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
ENCODER_SHAPES = [(1, 89, 256), (2, 89, 256), (1, 151, 384), (1, 151, 512), (2, 151, 384),
                  (2, 151, 512), (1, 89, 1024)]


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
    # the attention grid streams keys in tiles at every T (64 keys at head dim
    # 64, 32 at 128, 16 at 256), so T does not bound it; one head of width 1024
    # does not fit (its Q alone, split for 3xTF32, is 512 KB)
    assert ops_encoder_layer.key_tile(256, 4) == 64
    assert ops_encoder_layer.key_tile(1024, 1) == -1
    layer = TorchEncoderLayer(256, 4, 1024).to(cuda_device).eval()
    wide = TorchEncoderLayer(1024, 1, 1024).to(cuda_device).eval()
    before = ops_encoder_layer.launches
    with torch.no_grad():
        ops_encoder_layer.encoder_layer(torch.randn(1, 336, 256, device=cuda_device), layer)
        ops_encoder_layer.encoder_layer(torch.randn(1, 400, 256, device=cuda_device), layer)
        with pytest.raises(ValueError, match="shared memory"):
            ops_encoder_layer.encoder_layer(torch.randn(1, 64, 1024, device=cuda_device), wide)
    assert ops_encoder_layer.launches == before + 2


# the attention grid's key tiles: HumanML3D's text-to-motion trunk (T 197, head
# dim 128: 32-key tiles, the last one 5 keys), T 177, T 400 at head dim 64
# (64-key tiles, the last one 16 keys) and T 337 (a 17-key last tile)
TILED_SHAPES = [(2, 197, 512), (3, 177, 512), (2, 400, 256), (1, 337, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", TILED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_encoder_layer_key_tiles_match_plain(cuda_device, shape, mxu_bf16):
    B, T, D = shape
    torch.manual_seed(0)
    layer = TorchEncoderLayer(D, 4, 1024).to(cuda_device).eval()
    assert ops_encoder_layer.key_tile(D, 4) == {256: 64, 512: 32}[D]
    x = torch.randn(B, T, D, device=cuda_device)
    before = (ops_encoder_layer.launches, ops_encoder_layer.launches_bf16)
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(x, layer, mxu_bf16=mxu_bf16)
        again = ops_encoder_layer.encoder_layer(x, layer, mxu_bf16=mxu_bf16)
        ref = layer(x, mxu_bf16=mxu_bf16)
    after = (ops_encoder_layer.launches, ops_encoder_layer.launches_bf16)
    assert after == (before[0] + 2 * (not mxu_bf16), before[1] + 2 * mxu_bf16)
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= (1e-2 if mxu_bf16 else 1e-4)


# the wgmma design: row tiles over ragged row counts (B·T = 89, 151, 302, 1,424
# and 26,700 at the distillation batch), widths 256 / 384 / 512 / 1024 at head
# counts 1 / 4 / 8 (head dims 48 to 256: 64-, 32- and 16-key tiles), and key
# tiles past T at T 197 and 400
DESIGN_SHAPES = [(1, 89, 256, 4), (1, 151, 512, 4), (2, 151, 512, 8), (16, 89, 256, 4),
                 (1, 89, 256, 1), (2, 151, 384, 8), (1, 89, 1024, 8), (1, 89, 1024, 4),
                 (6, 197, 512, 4), (2, 400, 256, 4), (300, 89, 256, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DESIGN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "relu"])
def test_cuda_encoder_layer_wgmma_design_matches_plain(cuda_device, activation, shape, mxu_bf16):
    """Kernel B against the plain layer (1e-4 in f32, 1e-2 in bf16) and two
    calls bitwise equal, at the shapes that exercise its plan."""
    B, T, D, H = shape
    torch.manual_seed(0)
    layer = TorchEncoderLayer(D, H, 1024, activation).to(cuda_device).eval()
    x = torch.randn(B, T, D, device=cuda_device)
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(x, layer, mxu_bf16=mxu_bf16)
        again = ops_encoder_layer.encoder_layer(x, layer, mxu_bf16=mxu_bf16)
        ref = layer(x, mxu_bf16=mxu_bf16)
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= (1e-2 if mxu_bf16 else 1e-4)


# kernel B's two weight paths in float32: the GEMM grids read the weight planes
# (split once per weight version) or split each weight tile in shared memory;
# the server's batch, the distillation teacher's, TWH at B = 1 and text-to-motion
W_PATH_SHAPES = [(16, 89, 256), (300, 89, 256), (1, 151, 512), (6, 197, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", W_PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_encoder_layer_weight_paths_match_plain(cuda_device, shape):
    """Every GEMM grid on weight planes, then every one splitting its weight
    tiles (the plan built both ways through `_plan`): each within 1e-4 of the
    plain layer, repeat calls bitwise equal, and the two paths bitwise equal
    (the same operand bits, the same products in the same order)."""
    B, T, D = shape
    torch.manual_seed(0)
    layer = TorchEncoderLayer(D, 4, 1024).to(cuda_device).eval()
    x = torch.randn(B, T, D, device=cuda_device)
    sms = ops_encoder_layer.sm_count(cuda_device.index)
    outs = {}
    with torch.no_grad():
        ref = layer(x)
        for way in (True, False):
            grids, ints = ops_encoder_layer._plan(B, T, D, 4, 1024, False, sms, way)
            assert [g.planes for g in grids] == [int(way), 0, int(way), int(way), int(way)]
            before = ops_encoder_layer.launches_planes
            out = ops_encoder_layer._run(x, layer, False, grids, ints)
            again = ops_encoder_layer._run(x, layer, False, grids, ints)
            assert ops_encoder_layer.launches_planes == before + 8 * way
            assert torch.equal(out, again)
            assert (out - ref).abs().max().item() <= 1e-4
            outs[way] = out
    assert torch.equal(outs[True], outs[False])


@pytest.mark.cuda
def test_cuda_encoder_layer_weight_planes_follow_an_in_place_update(cuda_device):
    """An in-place weight update, then an eager call: the planes are split
    again into the same storage and the layer gives the new weights' result."""
    torch.manual_seed(0)
    layer = TorchEncoderLayer(256, 4, 1024).to(cuda_device).eval()
    x = torch.randn(16, 89, 256, device=cuda_device)
    assert all(g.planes for g in ops_encoder_layer.plan(16, 89, 256, 4, 1024)
               if g.name != "attention")
    weights = ops_encoder_layer.layer_weights
    with torch.no_grad():
        first = ops_encoder_layer.encoder_layer(x, layer)
        splits = ops_encoder_layer.splits
        planes = ops_encoder_layer.weight_planes(layer, weights(layer), cuda_device)
        ptr = planes.data_ptr()
        assert ops_encoder_layer.splits == splits  # held: no split
        layer.linear1.weight.mul_(0.5)
        layer.self_attn.in_proj_weight.add_(0.01)
        second = ops_encoder_layer.encoder_layer(x, layer)
        assert ops_encoder_layer.splits == splits + 1
        assert ops_encoder_layer.weight_planes(layer, weights(layer), cuda_device).data_ptr() == ptr
        assert (second - layer(x)).abs().max().item() <= 1e-4
        assert (second - first).abs().max().item() > 1e-2
        assert torch.equal(ops_encoder_layer.encoder_layer(x, layer), second)
    assert ops_encoder_layer.splits == splits + 1


@pytest.mark.cuda
def test_cuda_captured_zeggs_denoiser_at_b16_replays_on_weight_planes(cuda_device):
    """The ZEGGS denoiser at the server's batch of 16, captured as a CUDA
    graph: the capture's warm-up splits each layer's weights once, the
    capture and its replays split none, and each replay counts four GEMM
    grids on weight planes for each of its eight kernel-B launches; replays
    equal the eager call bitwise."""
    from diffusestylegesture_torch.utils import graphs

    torch.manual_seed(0)
    model = MDM(MDMConfig()).to(cuda_device).eval()
    g = torch.Generator().manual_seed(1)
    B = 16
    x = torch.randn(B, 1141, 1, 88, generator=g).to(cuda_device)
    cond = {"style": torch.eye(6)[torch.arange(B) % 6].to(cuda_device),
            "seed": torch.randn(B, 1141, 1, 8, generator=g).to(cuda_device),
            "audio": torch.randn(B, 88, 1024, generator=g).to(cuda_device),
            "mask_local": torch.ones(B, 88, dtype=torch.bool, device=cuda_device)}
    t = torch.full((B,), 500, device=cuda_device)
    gs = graphs.GraphSet(cuda_device)
    splits = ops_encoder_layer.splits
    with torch.no_grad():
        graph, out = gs.capture(lambda: model(x, t, cond))
        assert ops_encoder_layer.splits == splits + 8  # the warm-up, one a layer
        before = graphs.launch_counts()
        graph.replay(3)
        torch.cuda.synchronize()
        counts = tuple(b - a for a, b in zip(before, graphs.launch_counts()))
        assert counts == (3, 24, 0, 96)  # 32 GEMM grids on weight planes a call
        assert ops_encoder_layer.splits == splits + 8
        assert torch.equal(out, model(x, t, cond))


@pytest.mark.cuda
def test_cuda_encoder_layer_refuses_to_split_inside_a_capture(cuda_device):
    """A layer whose planes are not built raises in a capture rather than
    splitting there (in a subprocess: a failed capture leaves PyTorch's
    default CUDA generator in capture mode)."""
    code = (
        "import torch\n"
        "from diffusestylegesture_torch import resolve_device\n"
        "from diffusestylegesture_torch.models.transformer import TorchEncoderLayer\n"
        "from diffusestylegesture_torch.ops import encoder_layer as el\n"
        "dev = resolve_device('cuda')\n"
        "layer = TorchEncoderLayer(256, 4, 1024).to(dev).eval()\n"
        "x = torch.randn(16, 89, 256, device=dev)\n"
        "graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)\n"
        "with torch.no_grad():\n"
        "    el.encoder_layer(x[:1], layer)\n"  # B = 1 splits in shared memory: no planes
        "    assert el.splits == 0\n"
        "    try:\n"
        "        with torch.cuda.graph(graph, stream=stream):\n"
        "            el.encoder_layer(x, layer)\n"
        "    except RuntimeError as e:\n"
        "        print('refused:', e)\n"
        "print('splits', el.splits)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert "refused: encoder_layer: the layer's weight planes would be split inside a CUDA " \
           "graph capture" in res.stdout, res.stdout + res.stderr
    assert "splits 0" in res.stdout, res.stdout + res.stderr


@pytest.mark.cuda
def test_cuda_encoder_layer_source_takes_the_plans(cuda_device):
    """The CUDA source computes each grid's shared memory from the plan as
    ops/encoder_layer.py does, at every shape the plan test covers, and
    refuses a plan it cannot run."""
    import ctypes

    from test_torch_encoder_layer_plan import PORT_SHAPES

    lib = ops_encoder_layer._library()
    for (B, T, D, H, F) in PORT_SHAPES:
        for bf16 in (False, True):
            grids = ops_encoder_layer.plan(B, T, D, H, F, bf16)
            for i, g in enumerate(grids):
                ints = (ctypes.c_int * ops_encoder_layer.PLAN_INTS)(*g.ints())
                assert lib.dsg_encoder_layer_grid_smem(i + 1, int(bf16), ctypes.addressof(ints),
                                                       D, H, F) == g.smem, (B, T, D, H, F, g)
    bad = (ctypes.c_int * ops_encoder_layer.PLAN_INTS)(2, 4, 1, 3, 0, 0, 0)  # 128 x 256: none
    assert lib.dsg_encoder_layer_grid_smem(1, 0, ctypes.addressof(bad), 256, 4, 1024) == 0
    # weight planes: float32 GEMM grids only
    for which, bf16 in ((1, 1), (2, 0)):
        grid = ops_encoder_layer.plan(16, 89, 256, 4, 1024, bool(bf16))[which - 1]
        ints = (ctypes.c_int * ops_encoder_layer.PLAN_INTS)(*grid.ints()[:-1], 1)
        assert lib.dsg_encoder_layer_grid_smem(which, bf16, ctypes.addressof(ints),
                                               256, 4, 1024) == 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["3", "4", "5"])
@pytest.mark.parametrize("dataset", ["beat", "twh"])
def test_cuda_mdm_plus_kernel_path_matches_plain_path(cuda_device, dataset, variant):
    """The BEAT/TWH denoiser at its published widths (8 layers), each variant:
    kernel A once and kernel B eight times a call, within 1e-4 of the plain
    path, at B = 2 (the CFG batch)."""
    torch.manual_seed(0)
    make = beat_mdm if dataset == "beat" else twh_mdm
    model = make(cond_mode=f"cross_local_attention{variant}_style1").to(cuda_device).eval()
    plain = make(cond_mode=model.cfg.cond_mode, impl="plain").to(cuda_device).eval()
    plain.load_state_dict(model.state_dict())
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)
    seed_shape = (2, cfg.njoints, 1, cfg.n_seed)
    a_len = 150 - cfg.n_seed * (int(variant) - 3)
    cond = {"style": torch.eye(cfg.style_dim_in)[[0, 1]],
            "seed": torch.randn(seed_shape, generator=g),
            "seed_last": torch.randn(seed_shape, generator=g),
            "audio": torch.randn(2, a_len, cfg.source_audio_dim, generator=g),
            "mask_local": torch.ones(2, 150, dtype=torch.bool)}
    cond = {k: v.to(cuda_device) for k, v in cond.items()}
    x = torch.randn(2, cfg.njoints, 1, 150, generator=g).to(cuda_device)
    t = torch.tensor([999, 3], device=cuda_device)
    la0, el0 = ops_local_attention.launches, ops_encoder_layer.launches
    with torch.no_grad():
        out = model(x, t, cond, uncond=torch.tensor([False, True], device=cuda_device))
        ref = plain(x, t, cond, uncond=torch.tensor([False, True], device=cuda_device))
    assert (ops_local_attention.launches - la0, ops_encoder_layer.launches - el0) == (1, 8)
    assert (out - ref).abs().max().item() <= 1e-4


# ---- the distillation teacher's batch, and a second card ----------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("masked", ["all", "partial"])
def test_cuda_local_attention_at_the_distillation_batch(cuda_device, masked):
    """The teacher's call in a distillation step: q = k = v, B = 300."""
    qkv, mask, out, packed = local_attention_case(cuda_device, (88, 11, 32), 300, masked, True,
                                                  "merged")
    with torch.no_grad():
        res = ops_local_attention.local_attention(*qkv, 11, mask, heads=8, out=out)
        ref = local_attention_plain(*packed, 11, mask, heads=8)
    assert (res.reshape(ref.shape) - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_cuda_encoder_layer_at_the_distillation_batch(cuda_device):
    torch.manual_seed(0)
    layer = TorchEncoderLayer(256, 4, 1024).to(cuda_device).eval()
    x = torch.randn(300, 89, 256, device=cuda_device)
    with torch.no_grad():
        out = ops_encoder_layer.encoder_layer(x, layer)
        ref = layer(x)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_kernels_opt_in_on_a_second_card(cuda_device):
    """The dynamic shared-memory opt-in belongs to a device: launches on cuda:1
    after cuda:0 need it there too. Kernel A with distinct q, k, v at w 32, D 128
    takes ~84 KB, and each of kernel B's grids at the ZEGGS shapes over 48 KB."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    torch.manual_seed(0)
    cpu_layer = TorchEncoderLayer(256, 4, 1024).eval()
    x = torch.randn(2, 89, 256)
    for index in (0, 1):
        dev = resolve_device(f"cuda:{index}")
        qkv, mask, out, packed = local_attention_case(dev, (64, 32, 128), 2, "partial", False,
                                                      "packed")
        layer = TorchEncoderLayer(256, 4, 1024).to(dev).eval()
        layer.load_state_dict(cpu_layer.state_dict())
        with torch.no_grad():
            res = ops_local_attention.local_attention(*qkv, 32, mask, heads=8)
            ref = local_attention_plain(*packed, 32, mask, heads=8)
            y = ops_encoder_layer.encoder_layer(x.to(dev), layer)
            y_ref = layer(x.to(dev))
        torch.cuda.synchronize(dev)
        assert res.device == dev and (res - ref).abs().max().item() <= 1e-5
        assert y.device == dev and (y - y_ref).abs().max().item() <= 1e-4


# ---- BEAT/TWH training on the card ----------------------------------------------------


@pytest.mark.cuda
def test_cuda_beat_twh_captured_train_step_equals_eager(cuda_device):
    """The BEAT/TWH device-cache train step at the full TWH width (MDMPlus
    2232 / 512, 8 layers, attention4; clip crops drawn on the card): three
    steps captured as one CUDA graph (`cli/train.py --device_cache`) and
    eagerly, bitwise equal, the generators equal, and no kernel launched."""
    from diffusestylegesture_torch import diffusion as D
    from diffusestylegesture_torch.data.device_cache import (DeviceWindowCache,
                                                             make_device_data_train_step)
    from diffusestylegesture_torch.train import TrainConfig, TrainState, make_beat_cond_builder
    from diffusestylegesture_torch.utils.graphs import CapturedStep

    rng = np.random.default_rng(0)
    lens = (400, 333, 512)
    cache = DeviceWindowCache(
        {"motion_clips": rng.standard_normal((3, 512, 2232)).astype(np.float32),
         "audio_clips": rng.standard_normal((3, 512, 1435)).astype(np.float32),
         "style": np.eye(17, dtype=np.float32)[[1, 5, 9]], "clip_len": np.array(lens)},
        cuda_device, functools.partial(DeviceWindowCache.sample_clip_batch, n_poses=150))
    cfg = TrainConfig(lr=3e-5, ema_rate=0.999)
    sched = D.Schedule.create(D.named_beta_schedule("cosine", 1000), device=cuda_device)
    step = make_device_data_train_step(
        sched, cfg, make_beat_cond_builder("cross_local_attention4_style1", 30), 16,
        cache.sample_fn)

    def fresh():
        torch.manual_seed(0)
        state = TrainState(twh_mdm(impl="plain").to(cuda_device), cfg, 1000)
        return state, torch.Generator(device=cuda_device).manual_seed(1)

    eager, gen_e = fresh()
    captured, gen_c = fresh()
    run = CapturedStep(lambda: step.device_step(captured, gen_c, cache.arrays), cuda_device,
                       [gen_c])
    la0, el0 = ops_local_attention.launches, ops_encoder_layer.launches
    for _ in range(3):
        m_e = step(eager, gen_e, cache.arrays)
        m_c = run()
    torch.cuda.synchronize()
    assert (ops_local_attention.launches - la0, ops_encoder_layer.launches - el0) == (0, 0)
    for name in ("data", "grad"):
        assert torch.equal(getattr(eager.params, name), getattr(captured.params, name)), name
    for name in ("mu", "nu", "count"):
        assert torch.equal(getattr(eager.optimizer, name), getattr(captured.optimizer, name))
    assert torch.equal(eager.ema, captured.ema)
    assert all(torch.equal(m_e[k], m_c[k]) for k in m_e)
    assert torch.equal(gen_e.get_state(), gen_c.get_state())
    assert bool(torch.isfinite(m_c["loss"]).all())
