"""`scripts/convert_orbax_to_torch.py` and the port's CLI on its output.

A tiny JAX MDM is saved the three ways the JAX CLI loads: a bare orbax
params dir, a TrainLoop checkpoint (TrainState with EMA params, `ema_rate`
> 0) and a distilled-student stage dir (`params/` + `schedule.json`). Each
is converted by the script; the port's CLI helpers load the result, and its
forward agrees with `MDM.apply` at 5e-4 (the converted-weight bar).
`--use_ema` picks the EMA weights where the TrainState has them and the
params otherwise. On the stage dir both CLIs pick the same DDIM grid, the
same sampler (ddpm → ddim, `--respace` ignored) and the same gate key. A
tiny BEAT/TWH `MDMPlus` (cross_local_attention5, which adds `embed_text_last`)
saved as a bare params dir converts the same way: `load_reference_mdm_plus`
of its `model.pt` agrees with `MDMPlus.apply` at 5e-4.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp

from diffusestylegesture_tpu.cli import sample as jax_cli
from diffusestylegesture_tpu.models import mdm_plus as jax_mdm_plus
from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
from diffusestylegesture_tpu.sample import quality_gate as jax_gate
from diffusestylegesture_tpu.train.checkpoint import CheckpointManager
from diffusestylegesture_tpu.train.state import TrainConfig, create_train_state
from diffusestylegesture_torch.cli import sample as torch_cli
from diffusestylegesture_torch.models.convert import load_reference_mdm, load_reference_mdm_plus
from diffusestylegesture_torch.models.mdm import MDMConfig
from diffusestylegesture_torch.models.mdm_plus import MDMPlusConfig
from diffusestylegesture_torch.sample import quality_gate as torch_gate

from test_torch_isolation import write_tiny_run
from torch_port_utils import np32, randomize_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MDM_KW = dict(njoints=1141, latent_dim=96, ff_size=64, num_layers=1, n_seed=8)
GRID = list(range(0, 1000, 143))  # a 7-step student grid (gated key distill7)


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_to_torch", os.path.join(REPO, "scripts", "convert_orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1141, 1, 88)).astype(np.float32)
    t = np.array([999, 17], np.int64)
    cond = {"style": np.eye(6, dtype=np.float32)[[0, 3]],
            "seed": rng.standard_normal((2, 1141, 1, 8)).astype(np.float32),
            "audio": rng.standard_normal((2, 88, 32)).astype(np.float32),
            "mask_local": np.ones((2, 88), bool)}
    return x, t, cond


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    fm = FlaxMDM(FlaxMDMConfig(**MDM_KW))
    x, t, cond = _inputs()
    init = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]), jnp.asarray(t[:1]),
                            {k: jnp.asarray(v[:1]) for k, v in cond.items()})
    params = {"params": randomize_flax_params(init["params"], 0)}
    ema = {"params": randomize_flax_params(init["params"], 1)}

    bare = str(tmp / "bare")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(bare, params)
    ckptr.wait_until_finished()

    train = str(tmp / "train")
    state = create_train_state(params, TrainConfig(ema_rate=0.9)).replace(ema_params=ema)
    mgr = CheckpointManager(train)
    mgr.save(5, state, wait=True)
    mgr.close()

    stage = tmp / "stage1_steps7"
    stage.mkdir()
    ckptr.save(str(stage / "params"), params)
    ckptr.wait_until_finished()
    (stage / "schedule.json").write_text(json.dumps(
        {"base_steps": 1000, "noise_schedule": "cosine", "use_timesteps": GRID}))

    convert = _converter().convert
    out = {}
    for name, path in (("bare", bare), ("train", train), ("stage", str(stage))):
        out[name] = str(tmp / f"{name}_torch")
        convert(path, out[name])
    return dict(fm=fm, params=params, ema=ema, src={"stage": str(stage)}, out=out, tmp=tmp)


def _forward_err(ckpt, fm, params):
    x, t, cond = _inputs()
    model = load_reference_mdm(ckpt, MDMConfig(**MDM_KW, audio_in_dim=32), device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    {k: torch.from_numpy(v) for k, v in cond.items()})
    ref = fm.apply(params, jnp.asarray(x), jnp.asarray(t),
                   {k: jnp.asarray(v) for k, v in cond.items()})
    return float(np.abs(np32(out) - np.asarray(ref)).max())


@pytest.mark.parametrize("layout", ["bare", "train", "stage"])
def test_converted_forward_matches_flax(checkpoints, layout):
    c = checkpoints
    files = sorted(os.listdir(c["out"][layout]))
    assert files == {"bare": ["model.pt"], "train": ["model.pt", "model_ema.pt"],
                     "stage": ["model.pt", "schedule.json"]}[layout]
    assert _forward_err(torch_cli.model_checkpoint(c["out"][layout], False), c["fm"],
                        c["params"]) <= 5e-4


def test_use_ema_picks_the_ema_weights(checkpoints, capsys):
    c = checkpoints
    ema_pt = torch_cli.model_checkpoint(c["out"]["train"], True)
    assert os.path.basename(ema_pt) == "model_ema.pt"
    assert _forward_err(ema_pt, c["fm"], c["ema"]) <= 5e-4
    assert _forward_err(ema_pt, c["fm"], c["params"]) > 1e-2  # not the params
    # no EMA in the checkpoint: the params, with a note (JAX: params silently)
    assert torch_cli.model_checkpoint(c["out"]["bare"], True).endswith("model.pt")
    assert "no EMA params" in capsys.readouterr().out


class _Stop(Exception):
    pass


def _record(seen):
    def sampler(model_apply, wavlm_apply, schedule, cfg, *args, **kwargs):
        seen["sampler"] = cfg.sampler
        seen["grid"] = np.asarray(schedule.timestep_map).tolist()
        raise _Stop

    return sampler


@pytest.mark.parametrize("extra", [[], ["--respace", "5"]], ids=["plain", "respace"])
def test_stage_dir_serving_matches_jax_cli(checkpoints, monkeypatch, extra):
    c = checkpoints
    run_dir = c["tmp"] / f"run{len(extra)}"
    run_dir.mkdir()
    cfg_path, _, wav = write_tiny_run(run_dir, diffusion_steps=1000)
    seen = {"jax": {}, "torch": {}}
    for name, gate, cli, model_path in (("jax", jax_gate, jax_cli, c["src"]["stage"]),
                                        ("torch", torch_gate, torch_cli, c["out"]["stage"])):
        real = gate.check_key

        def check_key(key, *args, _real=real, _seen=seen[name], **kw):
            _seen["gate"] = (key, kw.get("diffusion_steps"))
            return _real(key, *args, **kw)

        monkeypatch.setattr(gate, "check_key", check_key)
        if name == "torch":
            monkeypatch.setattr(torch_cli, "check_key", check_key)
        monkeypatch.setattr(cli, "ZeggsSampler", _record(seen[name]))
        argv = ["--config", cfg_path, "--model_path", model_path, "--audiowavlm_path", wav,
                "--save_dir", str(c["tmp"] / "out")] + extra
        with pytest.raises(_Stop):
            cli.main(argv + (["--device", "cpu"] if name == "torch" else []))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == {"gate": ("distill7", 1000), "sampler": "ddim", "grid": GRID}


def test_mdm_plus_params_convert(tmp_path):
    kw = dict(njoints=36, latent_dim=64, ff_size=48, num_layers=1, source_audio_dim=40,
              audio_feat_dim=16, style_dim_in=4, n_seed=5,
              cond_mode="cross_local_attention5_style1")
    fm = jax_mdm_plus.MDMPlus(jax_mdm_plus.MDMPlusConfig(**kw))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 36, 1, 30)).astype(np.float32)
    t = np.array([999, 17], np.int64)
    cond = {"style": np.eye(4, dtype=np.float32)[[0, 3]],
            "seed": rng.standard_normal((2, 36, 1, 5)).astype(np.float32),
            "seed_last": rng.standard_normal((2, 36, 1, 5)).astype(np.float32),
            "audio": rng.standard_normal((2, 20, 40)).astype(np.float32),
            "mask_local": np.ones((2, 30), bool)}
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    init = jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jcond)
    params = {"params": randomize_flax_params(init["params"], 3)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "bare"), params)
    ckptr.wait_until_finished()
    written = _converter().convert(str(tmp_path / "bare"), str(tmp_path / "out"))
    assert [os.path.basename(p) for p in written] == ["model.pt"]
    model = load_reference_mdm_plus(written[0], MDMPlusConfig(**kw), device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    {k: torch.from_numpy(v) for k, v in cond.items()})
    ref = fm.apply(params, jnp.asarray(x), jnp.asarray(t), jcond)
    assert float(np.abs(np32(out) - np.asarray(ref)).max()) <= 5e-4
