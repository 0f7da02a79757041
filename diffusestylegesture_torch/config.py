"""YAML configuration with attribute access (same pattern as the reference's
`configs/parse_args.py` + EasyDict, and the JAX package's `config.py`)."""
from __future__ import annotations

from types import SimpleNamespace

import yaml


class Config(SimpleNamespace):
    def get(self, k, default=None):
        return getattr(self, k, default)


def load_yaml_config(path: str) -> Config:
    with open(path) as f:
        return Config(**(yaml.safe_load(f) or {}))
