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
`models/convert.py::mdm_plus_state_dict_from_flax`, which carries whatever
scopes the params hold: `embed_text_last` of a cross_local_attention5 MDMPlus,
the other MDM variants' `input_process_plain`, `seqTransDecoder` or `gru`,
and a MoE trunk's per-layer `moe` router and expert stacks (the port's serving
CLIs read the expert count from `model.pt`). `--out`
receives `model.pt` (the model in reference checkpoint layout), `model_ema.pt`
when the TrainState holds EMA params, and the stage dir's `schedule.json`.
Pass the directory to `python -m diffusestylegesture_torch.cli.sample
--model_path` (ZEGGS) or `cli.sample_beat --model_path` (BEAT/TWH).

A ZeroEGGS save dir of the JAX `cli/zeroeggs.py train` (`config.json` beside
the orbax `params/` of the speech encoder, style encoder and decoder) is
recognized by its `config.json`: `--out` receives `model.pt` (through
`models/convert.py::zeroeggs_state_dict_from_flax`) and a copy of
`config.json`, which `python -m diffusestylegesture_torch.cli.zeroeggs generate
--network` reads.

A text-to-motion save dir of the JAX `cli/train_t2m.py` (`t2m_config.json`
beside the numbered orbax steps) is recognized by its `t2m_config.json`:
`--out` receives `<step>/model.pt` (and `model_ema.pt` when the TrainState
holds EMA params) for the latest step, through
`models/convert.py::text_mdm_state_dict_from_flax`, and the config. A caption
encoder spec that names only a seed (no `params_path`) stands for the JAX
`ClipTextEncoder` initialised from `jax.random.PRNGKey(seed)`: its weights are
written to `<out>/clip_text.npz` (the flat npz of the JAX
`train/checkpoint.py::save_params_npz`) and the spec names that file, so that
`python -m diffusestylegesture_torch.cli.generate --model_path <out>` (and the
JAX one) serve it.
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


def convert_zeroeggs(save_dir: str, out_dir: str) -> list:
    """A JAX ZeroEGGS save dir → `model.pt` + `config.json` in `out_dir`."""
    import jax
    import orbax.checkpoint as ocp
    import torch

    from diffusestylegesture_torch.models.convert import zeroeggs_state_dict_from_flax

    params = ocp.StandardCheckpointer().restore(os.path.abspath(os.path.join(save_dir, "params")))
    params = jax.tree_util.tree_map(np.asarray, params)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.pt")
    torch.save(zeroeggs_state_dict_from_flax(params), path)
    config = os.path.join(out_dir, "config.json")
    if os.path.abspath(config) != os.path.abspath(os.path.join(save_dir, "config.json")):
        shutil.copy(os.path.join(save_dir, "config.json"), config)
    return [path, config]


def convert_t2m(save_dir: str, out_dir: str) -> list:
    """A JAX train_t2m save dir → `<step>/model.pt` [`model_ema.pt`],
    `t2m_config.json` and, for a seed-only encoder spec, `clip_text.npz`."""
    import json

    import jax
    import jax.numpy as jnp
    import torch

    from diffusestylegesture_tpu.cli.sample import load_orbax_params
    from diffusestylegesture_tpu.models.clip_text import ClipTextConfig, ClipTextEncoder
    from diffusestylegesture_tpu.train.checkpoint import save_params_npz
    from diffusestylegesture_torch.models.convert import text_mdm_state_dict_from_flax

    with open(os.path.join(save_dir, "t2m_config.json")) as f:
        cfg = json.load(f)
    step = max(int(d) for d in os.listdir(save_dir) if d.isdigit())
    step_dir = os.path.join(out_dir, str(step))
    os.makedirs(step_dir, exist_ok=True)

    def save(tree, name):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        path = os.path.join(step_dir, name)
        torch.save(text_mdm_state_dict_from_flax(tree), path)
        return path

    written = [save(load_orbax_params(save_dir), "model.pt")]
    if trainstate_has_ema(save_dir):
        written.append(save(load_orbax_params(save_dir, use_ema=True), "model_ema.pt"))
    clip = dict(cfg["clip"])
    if not clip.get("params_path"):
        ccfg = ClipTextConfig(vocab_size=clip["vocab_size"], width=clip["width"],
                              layers=clip["layers"], heads=clip["heads"],
                              context_length=clip["context_length"],
                              projection_dim=clip["projection_dim"])
        params = ClipTextEncoder(ccfg).init(
            jax.random.PRNGKey(clip["seed"]),
            jnp.zeros((1, clip["context_length"]), jnp.int32))["params"]
        path = os.path.join(out_dir, "clip_text.npz")
        save_params_npz(path, params)
        written.append(path)
        clip["params_path"] = "clip_text.npz"
    path = os.path.join(out_dir, "t2m_config.json")
    with open(path, "w") as f:
        json.dump({**cfg, "clip": clip}, f, indent=1)
    written.append(path)
    return written


def convert(model_path: str, out_dir: str) -> list:
    """Writes the port's files for `model_path` into `out_dir`; returns their paths."""
    import jax
    import torch

    if os.path.exists(os.path.join(model_path, "config.json")):
        return convert_zeroeggs(model_path, out_dir)
    if os.path.exists(os.path.join(model_path, "t2m_config.json")):
        return convert_t2m(model_path, out_dir)

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
                   help="orbax params dir, TrainLoop checkpoint dir, distill stage dir or "
                        "ZeroEGGS or train_t2m save dir")
    p.add_argument("--out", required=True, help="directory for model.pt [model_ema.pt] "
                                                "[schedule.json | config.json]")
    args = p.parse_args(argv)
    for path in convert(args.model_path, args.out):
        print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
