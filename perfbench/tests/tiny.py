"""Small stand-ins of the benchmark's configurations and traffic, for runs on the CPU."""
from __future__ import annotations

import copy

from perfbench.harness import registry

TINY_WAVLM = {
    "extractor_mode": "layer_norm", "encoder_layers": 1, "encoder_embed_dim": 32,
    "encoder_ffn_embed_dim": 64, "encoder_attention_heads": 4, "layer_norm_first": True,
    "conv_feature_layers": [[16, 10, 5], [16, 3, 2], [16, 3, 2], [16, 3, 2], [16, 3, 2],
                            [16, 2, 2], [16, 2, 2]],
    "conv_pos": 16, "conv_pos_groups": 4, "num_buckets": 32, "max_distance": 80,
}


def config(name: str) -> dict:
    """The configuration at toy widths and 10 diffusion steps (the run's shapes
    and code paths, none of its sizes)."""
    cfg = copy.deepcopy(registry.config(registry.benchmark(), name))
    cfg.update(latent_dim=32, ff_size=64, num_layers=1, num_heads=2, local_heads=4,
               diffusion_steps=10)
    if name == "zeggs":
        cfg.update(njoints=12, style_dim=8, audio_in_dim=32, wavlm=TINY_WAVLM)
    else:
        cfg.update(njoints=24, source_audio_dim=20, audio_feat_dim=8, motion_dim=8)
    return cfg


def traffic(name: str) -> dict:
    t = copy.deepcopy(registry.traffic(name))
    if "server" in t:
        t["server"]["max_batch"] = 4
    if t["driver"] == "closed":
        t["clients"] = min(t["clients"], 6)
    else:
        t["arrivals"] = {"poisson": 8.0}
    if "windows" in t["clips"]:
        lo = t["clips"]["windows"]["uniform_int"][0]
        t["clips"]["windows"] = {"uniform_int": [min(lo, 2), 3]}
    return t
