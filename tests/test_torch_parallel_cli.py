"""`cli.train` on a mesh, on the CPU: two ranks started as `torchrun` would
start them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT, gloo
because of `--device cpu`), on the prepared ZEGGS clips of
`test_torch_train_loop.py` (tiny MDM, dropout 0.1, condition drop 0.1).

Every draw is made at the global batch, so `--use_mesh --fsdp`, `--tp 2` and
`--sp 2` log the losses of the one-process run within 1e-5 relative, step by
step, and `--pp 2` with 2 microbatches (a 2-layer yaml; its dropout masks
are drawn per layer at the global batch, whatever the microbatches) those of
the one-process `--pp 1` run with 4. Rank 0 writes the checkpoint, in the reference layout
(`--tp` trains the split q/k/v layout), and `cli.sample` serves it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_train_loop import prepared  # noqa: F401  (the module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ("import sys, torch; from diffusestylegesture_torch.cli import train; "
       "out = train.main(sys.argv[2:]); "
       "torch.save([float(l['loss']) for l in out['loop'].logged], sys.argv[1])")
STEPS = 3


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(tmp, name, world, args):
    """cli.train started on `world` ranks."""
    save = str(tmp / name)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RUN, str(tmp / f"{name}_{rank}.pt")] + args
            + ["--device", "cpu", "--num_steps", str(STEPS), "--log_interval", "1",
               "--save_dir", save], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return tmp, name, world, save, procs


def _finish(run):
    """The run's logged losses (rank 0's) and its save dir."""
    tmp, name, world, save, procs = run
    logs = []
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-5000:]
    losses = [torch.load(tmp / f"{name}_{r}.pt") for r in range(world)]
    assert all(len(ls) == STEPS for ls in losses)
    assert all(ls == losses[0] for ls in losses)  # every rank logs the global batch
    return np.array(losses[0]), save


@pytest.fixture(scope="module")
def runs(prepared, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("cli_mesh")
    cfg = str(prepared / "zeggs.yml")
    with open(cfg) as f:
        two = dict(yaml.safe_load(f), num_layers=2)
    cfg2 = str(tmp / "zeggs_2layers.yml")
    with open(cfg2, "w") as f:
        yaml.safe_dump(two, f)
    started = {"one": _start(tmp, "one", 1, ["--config", cfg])}
    for name, world, args in (("fsdp", 2, ["--config", cfg, "--use_mesh", "--fsdp"]),
                              ("tp", 2, ["--config", cfg, "--tp", "2"]),
                              ("sp", 2, ["--config", cfg, "--sp", "2"]),
                              ("pp1", 1, ["--config", cfg2, "--pp", "1",
                                          "--pipe_microbatches", "4"]),
                              ("pp", 2, ["--config", cfg2, "--pp", "2",
                                         "--pipe_microbatches", "2"])):
        started[name] = _start(tmp, name, world, args)
    out = {name: _finish(run) for name, run in started.items()}
    out["cfg"] = cfg
    return out


@pytest.mark.parametrize("name", ["fsdp", "tp", "sp"])
def test_meshed_cli_logs_the_one_process_losses(runs, name):
    np.testing.assert_allclose(runs[name][0], runs["one"][0], rtol=1e-5)
    assert np.isfinite(runs[name][0]).all()


def test_pipelined_cli_logs_the_one_stage_losses(runs):
    np.testing.assert_allclose(runs["pp"][0], runs["pp1"][0], rtol=1e-5)


@pytest.mark.parametrize("name", ["fsdp", "tp", "pp"])
def test_rank_zero_saves_a_checkpoint_that_serves(runs, name, tmp_path):
    from diffusestylegesture_torch.cli import sample as sample_cli

    step_dir = os.path.join(runs[name][1], str(STEPS))
    sd = torch.load(os.path.join(step_dir, "model.pt"), weights_only=True)
    assert any(k.endswith("in_proj_weight") for k in sd)
    assert not any(k.endswith("q_proj.weight") for k in sd)
    ts = torch.load(os.path.join(step_dir, "train_state.pt"), weights_only=True)
    assert ts["step"] == STEPS and set(ts["optimizer"]["mu"]) == set(sd)
    if name != "fsdp":
        return
    with open(runs["cfg"]) as f:
        cfg = yaml.safe_load(f)
    res = sample_cli.main(["--config", runs["cfg"], "--model_path", step_dir,
                           "--audiowavlm_path", os.path.join(os.path.dirname(runs["cfg"]),
                                                             "015_Happy_4_x_1_0.wav"),
                           "--save_dir", str(tmp_path), "--device", "cpu",
                           "--sampler", "dpmpp", "--respace", "2"])
    assert np.isfinite(res["poses"]).all() and res["poses"].shape[-1] == cfg["njoints"]
