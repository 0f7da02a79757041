"""YAML configuration with attribute access (same pattern as the reference's
`configs/parse_args.py` + EasyDict, and the JAX package's `config.py`), and
the BEAT/TWH fields derived from the dataset and variant."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import yaml

# the three BEAT/TWH models (reference `end2end.py:66-72`)
BEAT_TWH_COND_MODES = {
    "DiffuseStyleGesture": "cross_local_attention3_style1",
    "DiffuseStyleGesture+": "cross_local_attention4_style1",
    "DiffuseStyleGesture++": "cross_local_attention5_style1",
}


class Config(SimpleNamespace):
    def get(self, k, default=None):
        return getattr(self, k, default)


def load_yaml_config(path: str, overrides: Optional[Dict] = None) -> Config:
    """The yaml as a Config; each override that is not None wins (a CLI flag
    left at its None default keeps the yaml's value)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    for k, v in (overrides or {}).items():
        if v is not None:
            cfg[k] = v
    return Config(**cfg)


def apply_beat_twh_derivations(cfg: Config) -> Config:
    """Dataset- and version-dependent fields, set in place (port of the JAX
    `config.py::apply_beat_twh_derivations`, reference `end2end.py:66-99`):
    cond_mode from the model name; style (speaker) count, fused feature width,
    motion and pose widths per dataset; TWH also fixes the latent widths.
    BEAT keeps the yaml's `latent_dim` and `audio_feat_dim_latent`."""
    cfg.cond_mode = BEAT_TWH_COND_MODES[cfg.name]
    version = cfg.get("version", "v0")
    if cfg.dataset == "BEAT":
        cfg.style_dim = 2
        cfg.audio_feature_dim = 1434
        if "v0" in version:
            cfg.motion_dim, cfg.njoints = 684, 2052
        elif "v2" in version:
            cfg.motion_dim, cfg.njoints = 1141, 1141
        else:
            raise NotImplementedError(f"BEAT version {version!r} (supported: v0*, v2*)")
    elif cfg.dataset == "TWH":
        cfg.motion_dim, cfg.njoints = 744, 2232
        cfg.latent_dim = 512
        cfg.audio_feat_dim_latent = 128
        cfg.style_dim = 17
        cfg.audio_feature_dim = 1435
    else:
        raise NotImplementedError(cfg.dataset)
    return cfg
