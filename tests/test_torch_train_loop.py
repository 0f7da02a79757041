"""The PyTorch port's training loop, checkpoints and CLI, on the CPU.

The loop runs, resumes with fresh randomness, returns at once when
relaunched after its end, labels each checkpoint with the steps its contents
completed, saves and stops on SIGTERM, returns after the first periodic save
under DIFFUSION_TRAINING_TEST, writes its log sinks and trains from the
on-device window cache. End to end: synthetic clips → `cli.prepare_data` →
`cli.train` (float32, bf16 autocast, device cache; a resumed run) → a
checkpoint that `cli.sample --model_path <dir>/<step>` serves as a BVH.
"""
import csv
import json
import os
import signal

import numpy as np
import pytest
import torch
import yaml

from diffusestylegesture_torch import diffusion as D
from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
from diffusestylegesture_torch.train import (CheckpointManager, KVLogger, LoopConfig, TrainConfig,
                                             TrainLoop, TrainState, load_params_npz,
                                             make_zeggs_cond_builder, save_params_npz)
from diffusestylegesture_torch.train.loop import train_seed

B, NJ, T, NSEED = 4, 16, 22, 4
SCHED = D.Schedule.create(D.named_beta_schedule("cosine", 20), device="cpu")


def new_model(seed=0):
    torch.manual_seed(seed)
    return MDM(MDMConfig(njoints=NJ, latent_dim=64, ff_size=32, num_layers=1, n_seed=NSEED,
                         impl="plain"))


def batches(n, seed=1):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"motion": rng.standard_normal((B, T, NJ)).astype(np.float32),
               "style": np.eye(6, dtype=np.float32)[rng.integers(0, 6, B)],
               "wavlm": rng.standard_normal((B, T, 1024)).astype(np.float32)}


def loop(ckpt_dir=None, num_steps=5, data=None, train_cfg=TrainConfig(lr=1e-3), **loop_kw):
    kw = dict(num_steps=num_steps, log_interval=100, save_interval=0, checkpoint_dir=ckpt_dir)
    kw.update(loop_kw)
    return TrainLoop(new_model(), SCHED, batches(20) if data is None else data,
                     train_cfg=train_cfg, loop_cfg=LoopConfig(**kw),
                     cond_builder=make_zeggs_cond_builder(NSEED), seed=3)


def test_loop_runs_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = loop(ckpt, 5)
    state = first.run()
    assert state.step == 5 and CheckpointManager(ckpt).latest_step() == 5
    second = loop(ckpt, 8)
    assert second.resume_step == 5
    # the restored weights are the saved ones; the generator starts a fresh stream
    assert torch.equal(second.state.params.data, first.state.params.data)
    assert train_seed(3, 5) != train_seed(3, 0)
    assert not torch.equal(second.generator.get_state(),
                           torch.Generator().manual_seed(3).get_state())
    assert second.run().step == 8
    assert int(second.state.optimizer.count) == 8


def test_relaunch_after_completion_is_a_noop(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    for _ in range(2):
        lp = loop(ckpt, 4)
        assert lp.run().step == 4
    assert "checkpoint for step 4 already exists" in capsys.readouterr().out
    assert CheckpointManager(ckpt).steps() == [4]


def test_checkpoint_labels_match_contents(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    lp = loop(ckpt, 5, save_interval=3, train_cfg=TrainConfig(lr=1e-3, ema_rate=0.9))
    lp.run()
    mgr = CheckpointManager(ckpt)
    assert mgr.steps() == [3, 5]
    assert sorted(os.listdir(os.path.join(ckpt, "3"))) == ["model.pt", "model_ema.pt",
                                                          "train_state.pt"]
    state = TrainState(new_model(1), TrainConfig(lr=1e-3, ema_rate=0.9), 20)
    saved = mgr.restore(state, step=3)
    assert state.step == 3 and int(state.optimizer.count) == 3
    assert saved["generator"] is not None
    final = TrainState(new_model(1), TrainConfig(lr=1e-3, ema_rate=0.9), 20)
    mgr.restore(final)
    assert final.step == 5 and torch.equal(final.params.data, lp.state.params.data)
    assert torch.equal(final.ema, lp.state.ema)
    assert not torch.equal(state.params.data, final.params.data)
    # the weights file is a plain state_dict of the model, as cli/sample loads it
    sd = torch.load(os.path.join(ckpt, "5", "model.pt"), weights_only=True)
    assert set(sd) == set(new_model().state_dict())


def test_checkpoints_beyond_max_to_keep_are_removed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = TrainState(new_model(), TrainConfig(), 20)
    for step in (1, 2, 3):
        state.step = step
        mgr.save(step, state)
    assert mgr.steps() == [2, 3]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_sigterm_saves_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")

    def data():
        for i, b in enumerate(batches(20)):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    lp = loop(ckpt, 10, data=data())
    state = lp.run()
    assert state.step == 3 and CheckpointManager(ckpt).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    resumed = loop(ckpt, 5)
    assert resumed.resume_step == 3 and resumed.run().step == 5


def test_diffusion_training_test_returns_after_first_save(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    ckpt = str(tmp_path / "ckpt")
    state = loop(ckpt, 10, save_interval=2).run()
    assert state.step == 2 and CheckpointManager(ckpt).steps() == [2]


def test_log_sinks(tmp_path):
    log_dir = str(tmp_path / "logs")
    lp = loop(None, 6, log_interval=2, log_dir=log_dir, log_formats=("csv", "json", "stdout"))
    lp.run()
    with open(os.path.join(log_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and [int(float(r["step"])) for r in rows] == [2, 4, 6]
    for r in rows:
        assert np.isfinite(float(r["loss"])) and float(r["ms_per_step"]) > 0
        assert any(k.startswith("rot_mse_q") and r[k] for k in r)
    with open(os.path.join(log_dir, "progress.json")) as f:
        assert len([json.loads(line) for line in f]) == 3
    assert [s for s, _ in lp.boundaries] == [0, 2, 4, 6]


def test_tensorboard_sink(tmp_path):
    logger = KVLogger(str(tmp_path), ("tensorboard",))
    logger.logkv("loss", 1.5)
    logger.dumpkvs()
    assert any(p.startswith("events.out.tfevents") for p in os.listdir(tmp_path))
    with pytest.raises(ValueError, match="log_dir"):
        KVLogger(None, ("csv",))


def test_device_cache_loop_runs_and_resumes(tmp_path):
    from diffusestylegesture_torch.data.device_cache import DeviceWindowCache

    rng = np.random.default_rng(0)
    cache = DeviceWindowCache({"motion": rng.standard_normal((10, T, NJ)).astype(np.float32),
                               "style": np.eye(6, dtype=np.float32)[rng.integers(0, 6, 10)],
                               "wavlm": rng.standard_normal((10, T, 1024)).astype(np.float32)},
                              device="cpu")
    ckpt = str(tmp_path / "ckpt")

    def run(n):
        return TrainLoop(new_model(), SCHED, None, TrainConfig(lr=1e-3),
                         LoopConfig(num_steps=n, log_interval=2, save_interval=0,
                                    checkpoint_dir=ckpt),
                         make_zeggs_cond_builder(NSEED), seed=0, device_cache=cache,
                         batch_size=B)

    assert run(3).run().step == 3
    lp = run(5)
    assert lp.resume_step == 3 and lp.run().step == 5
    with pytest.raises(ValueError, match="batch_size"):
        TrainLoop(new_model(), SCHED, None, device_cache=cache)


@pytest.mark.parametrize("field", [dict(use_mesh=True), dict(tensor_parallel=2),
                                   dict(fsdp=True)])
def test_mesh_fields_wait_for_a_later_slice(field):
    with pytest.raises(NotImplementedError, match="slice 9"):
        LoopConfig(**field)


def test_params_npz_round_trip(tmp_path):
    sd = new_model().state_dict()
    save_params_npz(str(tmp_path / "p.npz"), sd)
    back = load_params_npz(str(tmp_path / "p.npz"))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


# ---- the CLIs end to end ----------------------------------------------------------


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Synthetic clips → cli.prepare_data; a tiny WavLM checkpoint; a yaml."""
    from diffusestylegesture_torch.cli import prepare_data
    from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig
    from test_torch_isolation import TINY_WAVLM, _wavlm_reference_state_dict
    from test_torch_train_data import write_clip

    root = tmp_path_factory.mktemp("zeggs_run")
    src = root / "src"
    src.mkdir()
    for i, name in enumerate(("001_Happy_0_x_1_0", "002_Angry_0_x_1_0", "003_Relaxed_0_x_1_0")):
        write_clip(str(src), name, seconds=8.0, seed=i)
    prepare_data.main(["--dataset", "ZEGGS", "--source", str(src), "--target", str(root / "data")])
    torch.manual_seed(0)
    wcfg = WavLMConfig(**TINY_WAVLM)
    cfg_dict = {k: getattr(wcfg, k) for k in TINY_WAVLM}
    cfg_dict["conv_feature_layers"] = repr([tuple(t) for t in wcfg.conv_feature_layers])
    torch.save({"cfg": cfg_dict, "model": _wavlm_reference_state_dict(WavLM(wcfg))},
               str(root / "WavLM-Tiny.pt"))
    cfg = dict(dataset="ZEGGS", name="DiffuseStyleGesture", data_dir=str(root / "data"),
               n_poses=88, motion_resampling_framerate=20, subdivision_stride=10, batch_size=4,
               n_seed=8, njoints=1141, latent_dim=64, ff_size=32, num_layers=1, num_heads=4,
               cond_mask_prob=0.1, cond_mode="cross_local_attention3_style1",
               audio_feat="wavlm", diffusion_steps=4, noise_schedule="cosine", lr=3e-5,
               weight_decay=0.0, lr_anneal_steps=0, log_interval=2, save_interval=1000,
               num_steps=100, save_dir=str(root / "out"), wavlm_path=str(root / "WavLM-Tiny.pt"))
    with open(root / "zeggs.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    with open(src / "001_Happy_0_x_1_0.wav", "rb") as f:
        wav = f.read()
    with open(root / "015_Happy_4_x_1_0.wav", "wb") as f:
        f.write(wav)
    return root


@pytest.mark.parametrize("mode", [[], ["--bf16"], ["--device_cache"]],
                         ids=["f32", "bf16", "device_cache"])
def test_cli_train_then_sample_serves_the_checkpoint(prepared, tmp_path, mode):
    from diffusestylegesture_torch.cli import sample as sample_cli
    from diffusestylegesture_torch.cli import train as train_cli

    cfg = str(prepared / "zeggs.yml")
    save_dir = str(tmp_path / "ckpt")
    args = ["--config", cfg, "--device", "cpu", "--save_dir", save_dir] + mode
    res = train_cli.main(args + ["--num_steps", "2"])
    # 3 clips of 8 s, one held out: 2 × ⌊(160 − 88) / 10⌋ windows
    assert len(res["dataset"]) == 14 and res["state"].step == 2
    assert res["dataset"].wavlm.shape == (14, 88, 32)  # the tiny WavLM's features
    res = train_cli.main(args + ["--num_steps", "4"])  # resumes
    assert res["loop"].resume_step == 2 and res["state"].step == 4
    assert torch.isfinite(res["state"].params.data).all()
    assert res["state"].params.data.dtype == torch.float32
    out = sample_cli.main(["--config", cfg, "--model_path", os.path.join(save_dir, "4"),
                           "--audiowavlm_path", str(prepared / "015_Happy_4_x_1_0.wav"),
                           "--save_dir", str(tmp_path / "bvh"), "--device", "cpu",
                           "--sampler", "dpmpp", "--respace", "2"])
    assert len(out["paths"]) == 1 and os.path.getsize(out["paths"][0]) > 0
    assert out["poses"].shape == (1, 2 * 80 - 8, 1141) and np.isfinite(out["poses"]).all()


def test_cli_train_refuses_what_later_slices_bring(prepared):
    from diffusestylegesture_torch.cli import train as train_cli

    cfg = str(prepared / "zeggs.yml")
    for flags, slice_no in ((["--tp", "2"], 9), (["--use_mesh"], 9), (["--fsdp"], 9),
                            (["--pp", "2"], 9), (["--sp", "2"], 9), (["--split_qkv"], 9),
                            (["--moe_experts", "4"], 8)):
        with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
            train_cli.main(["--config", cfg, "--device", "cpu"] + flags)


def test_cli_train_refuses_cuda_without_a_card(prepared, monkeypatch):
    from diffusestylegesture_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--config", str(prepared / "zeggs.yml")])


def test_cli_train_needs_audio_features(prepared, tmp_path):
    from diffusestylegesture_torch.cli import train as train_cli

    with open(prepared / "zeggs.yml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(wavlm_path=str(tmp_path / "missing.pt"), data_dir=str(tmp_path / "data"))
    import shutil

    shutil.copytree(prepared / "data", tmp_path / "data",
                    ignore=shutil.ignore_patterns("_cache*"))
    with open(tmp_path / "cfg.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(ValueError, match="audio features"):
        train_cli.main(["--config", str(tmp_path / "cfg.yml"), "--device", "cpu"])
