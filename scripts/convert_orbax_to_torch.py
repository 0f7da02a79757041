#!/usr/bin/env python3
"""Convert a JAX package checkpoint (orbax) into files the PyTorch port reads.

A one-off tool that runs beside the JAX package (it imports jax, orbax and
`diffusestylegesture_tpu`), not on the machine that serves with the port:

    python scripts/convert_orbax_to_torch.py --model_path <dir> --out <dir>

`--model_path` is any layout the JAX `cli/sample.py` loads: a bare orbax
params dir (`cli/convert_ckpt.py`), a TrainLoop checkpoint dir (numbered
steps of the full TrainState, the latest is taken) or a distilled-student
stage dir (`cli/distill.py`: `params/` beside `schedule.json`), of the ZEGGS
`MDM` or of the BEAT/TWH `MDMPlus`. The params go through
`cli/sample.py::load_orbax_params` and the port's
`models/convert.py::mdm_plus_state_dict_from_flax` (the MDM's names, and
`embed_text_last` where a cross_local_attention5 model has it). `--out`
receives `model.pt` (the model in reference checkpoint layout), `model_ema.pt`
when the TrainState holds EMA params, and the stage dir's `schedule.json`.
Pass the directory to `python -m diffusestylegesture_torch.cli.sample
--model_path` (ZEGGS) or `cli.sample_beat --model_path` (BEAT/TWH).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def trainstate_has_ema(path: str) -> bool:
    """Whether a TrainLoop checkpoint dir's latest TrainState holds EMA params."""
    import orbax.checkpoint as ocp

    steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    if not steps:
        return False
    mgr = ocp.CheckpointManager(os.path.abspath(path))
    try:
        tree = mgr.restore(max(steps), args=ocp.args.PyTreeRestore())
    finally:
        mgr.close()
    return isinstance(tree, dict) and tree.get("ema_params") is not None


def convert(model_path: str, out_dir: str) -> list:
    """Writes the port's files for `model_path` into `out_dir`; returns their paths."""
    import jax
    import torch

    from diffusestylegesture_tpu.cli.sample import load_orbax_params
    from diffusestylegesture_torch.models.convert import mdm_plus_state_dict_from_flax

    def save(tree, name):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        path = os.path.join(out_dir, name)
        torch.save(mdm_plus_state_dict_from_flax(tree), path)
        return path

    os.makedirs(out_dir, exist_ok=True)
    written = [save(load_orbax_params(model_path), "model.pt")]
    if trainstate_has_ema(model_path):
        written.append(save(load_orbax_params(model_path, use_ema=True), "model_ema.pt"))
    schedule = os.path.join(model_path, "schedule.json")
    if os.path.exists(schedule):
        written.append(shutil.copy(schedule, os.path.join(out_dir, "schedule.json")))
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--model_path", required=True,
                   help="orbax params dir, TrainLoop checkpoint dir or distill stage dir")
    p.add_argument("--out", required=True, help="directory for model.pt [model_ema.pt] "
                                                "[schedule.json]")
    args = p.parse_args(argv)
    for path in convert(args.model_path, args.out):
        print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
