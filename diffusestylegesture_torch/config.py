"""YAML configuration with attribute access (same pattern as the reference's
`configs/parse_args.py` + EasyDict, and the JAX package's `config.py`)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import yaml


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
