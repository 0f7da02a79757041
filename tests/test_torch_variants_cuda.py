"""The MDM's other conditioning modes and trunks, the MoE trunk and the MFCC
engine on the card.

Imports neither jax nor the JAX package, so it runs on a machine with a card
and no JAX (skip the conftest there, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_variants_cuda.py

On the card: each MDM variant at the ZEGGS widths (1141 / 256 / 8 layers / 4
heads / ff 1024, window 11, MFCC audio) through its kernel path launches
kernel A and B the expected number of times a call (A once where the variant
has a local block, B once a dense encoder layer; none for a MoE layer, the
decoder or the GRU) and agrees with its plain path within 1e-4 at B = 2; a
MoE denoiser call replayed from a CUDA graph equals its eager call bitwise;
the MFCC `ZeggsSampler` on CUDA graphs equals its eager run bitwise.
Elsewhere every test skips.
"""
import numpy as np
import pytest
import torch

from diffusestylegesture_torch import diffusion as D
from diffusestylegesture_torch import resolve_device
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.ops import encoder_layer as ops_encoder_layer
from diffusestylegesture_torch.ops import local_attention as ops_local_attention
from diffusestylegesture_torch.sample import ZeggsEngineConfig, ZeggsSampler, make_mfcc_window_fn
from diffusestylegesture_torch.utils.graphs import GraphSet

# (config, kernel A launches, kernel B launches) a denoiser call
VARIANTS = {
    "cla3": (dict(), 1, 8),
    "cla5": (dict(cond_mode="cross_local_attention5_style1"), 1, 0),
    "cla": (dict(cond_mode="cross_local_attention_style1"), 1, 8),
    "style1_trans_enc": (dict(cond_mode="style1", arch="trans_enc"), 0, 8),
    "style2_trans_enc": (dict(cond_mode="style2", arch="trans_enc"), 0, 8),
    "style2_mytrans_enc": (dict(cond_mode="style2", arch="mytrans_enc"), 0, 8),
    "style2_trans_dec": (dict(cond_mode="style2", arch="trans_dec"), 0, 0),
    "style2_gru": (dict(cond_mode="style2", arch="gru"), 0, 0),
    "cla3_moe": (dict(moe_experts=4), 1, 0),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return resolve_device("cuda")


def _pair(dev, kw):
    torch.manual_seed(0)
    model = MDM(MDMConfig(audio_feat="mfcc", **kw)).to(dev).eval()
    plain = MDM(MDMConfig(audio_feat="mfcc", impl="plain", **kw)).to(dev).eval()
    plain.load_state_dict(model.state_dict())
    return model, plain


def _inputs(dev, B=2):
    g = torch.Generator().manual_seed(1)
    cond = {"style": torch.eye(6)[[0, 3]][:B], "seed": torch.randn(B, 1141, 1, 8, generator=g),
            "audio": torch.randn(B, 88, 13, generator=g),
            "mask_local": torch.ones(B, 88, dtype=torch.bool)}
    x = torch.randn(B, 1141, 1, 88, generator=g)
    return (x.to(dev), torch.tensor([999, 3][:B], device=dev),
            {k: v.to(dev) for k, v in cond.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_cuda_variant_kernel_path_matches_plain_path(cuda_device, name):
    kw, a, b = VARIANTS[name]
    model, plain = _pair(cuda_device, kw)
    x, t, cond = _inputs(cuda_device)
    uncond = torch.tensor([False, True], device=cuda_device)
    la0, el0 = ops_local_attention.launches, ops_encoder_layer.launches
    with torch.no_grad():
        out = model(x, t, cond, uncond=uncond)
        launches = (ops_local_attention.launches - la0, ops_encoder_layer.launches - el0)
        ref = plain(x, t, cond, uncond=uncond)
    assert launches == (a, b)
    assert out.shape == (2, 1141, 1, 88) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_moe_denoiser_replayed_from_a_graph_equals_eager(cuda_device):
    model, _ = _pair(cuda_device, VARIANTS["cla3_moe"][0])
    x, t, cond = _inputs(cuda_device, B=1)
    with torch.inference_mode():
        eager = model(x, t, cond)
        out = torch.empty_like(eager)
        graph, _ = GraphSet(cuda_device).capture(lambda: out.copy_(model(x, t, cond)))
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_cuda_mfcc_engine_graphs_equal_eager(cuda_device):
    torch.manual_seed(0)
    model = MDM(MDMConfig(njoints=64, latent_dim=128, ff_size=256, num_layers=2,
                          audio_feat="mfcc")).to(cuda_device).eval()
    betas = D.named_beta_schedule("cosine", 1000)
    sched = D.spaced_schedule(betas, D.space_timesteps(1000, "ddim5"), device=cuda_device)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(2 * 64000 + 300)).astype(np.float32)
    out = []
    for graphs in (None, False):
        sampler = ZeggsSampler(lambda m, x, tt, c, uncond=None: m(x, tt, c, uncond=uncond),
                               make_mfcc_window_fn(88), sched,
                               ZeggsEngineConfig(njoints=64, sampler="dpmpp"),
                               device=cuda_device, graphs=graphs)
        out.append(sampler.generate(model, None, audio, np.eye(6, dtype=np.float32)[[1]],
                                    torch.Generator(device=cuda_device).manual_seed(4)))
    assert out[0].shape == (1, 152, 64) and np.isfinite(out[0]).all()
    assert np.array_equal(out[0], out[1])
