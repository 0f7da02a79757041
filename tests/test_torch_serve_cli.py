"""Serving CLI of the PyTorch port (`cli/serve.py`) against the JAX CLI, on the CPU.

One tiny checkpoint in the reference layout (an MDM and a WavLM, seeded),
one JSONL: a request whose style comes from the wav's name, one with an
explicit style and output path, one with an unknown style and a malformed
line. Both CLIs print the same result keys and frame counts, an error line
for the unknown style and one for the malformed line, and `{"served": 2,
"batches": 1}`, to which the port's closing line adds its server's
counters. The JAX server's draws (its per-request keys, the batch run
under the first request's) are replayed into the port's DDPM loop: the
poses handed to the BVH writer agree within 2e-3 relative (the windowed
engine's bar) and the BVH files within that bar too, angles compared modulo
360°. The interactive client of `tests/test_serve_cli.py` (one request, wait
for its result, then the next) gets both results from the port's CLI.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest

import jax

from torch_port_utils import jax_loop_draws, rel_err, replay_draws
from test_torch_isolation import write_tiny_run

STEPS, WINDOWS, MAX_BATCH = 4, 2, 16


def _write_requests(tmp_path, wav):
    wav2 = str(tmp_path / "001_Sad_0.wav")
    os.link(wav, wav2)
    reqs = str(tmp_path / "reqs.jsonl")
    with open(reqs, "w") as f:
        f.write(json.dumps({"wav": wav}) + "\n")  # style from the file name
        f.write(json.dumps({"wav": wav2, "style": "Neutral",
                            "out": str(tmp_path / "explicit.bvh")}) + "\n")
        f.write(json.dumps({"wav": wav2, "style": "NotAStyle"}) + "\n")
        f.write("{not valid json\n")  # must not abandon the run
    return reqs


def _lines(text):
    out = []
    for line in text.strip().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def _spy(monkeypatch, module, store):
    real = module.pose_features_to_bvh

    def spy(poses, path, **kw):
        store[os.path.basename(path)] = np.array(poses)
        return real(poses, path, **kw)

    monkeypatch.setattr(module, "pose_features_to_bvh", spy)


def _bvh_values(path):
    with open(path) as f:
        text = f.read()
    motion = text.split("Frame Time:")[1].splitlines()[1:]
    return np.array([[float(v) for v in row.split()] for row in motion if row.strip()])


def test_serve_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    from diffusestylegesture_torch.cli import serve as torch_serve
    from diffusestylegesture_torch.motion import zeggs_features as torch_zf
    from diffusestylegesture_tpu.cli import serve as jax_serve
    from diffusestylegesture_tpu.motion import zeggs_features as jax_zf

    cfg_path, mdm_pt, wav = write_tiny_run(tmp_path, diffusion_steps=STEPS, seconds=4 * WINDOWS)
    reqs = _write_requests(tmp_path, wav)
    jax_dir, torch_dir = tmp_path / "jax", tmp_path / "torch"
    runs = {}
    for name, cli, zf, out_dir in (("jax", jax_serve, jax_zf, jax_dir),
                                   ("torch", torch_serve, torch_zf, torch_dir)):
        out_dir.mkdir()
        # the default output lands next to the wav: give each run its own copy
        with open(reqs) as f:
            text = f.read().replace(str(tmp_path / "explicit.bvh"), str(out_dir / "explicit.bvh"))
        run_reqs = str(out_dir / "reqs.jsonl")
        with open(run_reqs, "w") as f:
            f.write(text.replace(str(tmp_path) + "/0", str(out_dir) + "/0"))
        for w in ("015_Happy_4_x_1_0.wav", "001_Sad_0.wav"):
            os.link(tmp_path / w, out_dir / w)
        poses = {}
        _spy(monkeypatch, zf, poses)
        argv = ["--config", cfg_path, "--model_path", mdm_pt, "--requests", run_reqs,
                "--max_delay_ms", "500"]
        if name == "torch":
            # the JAX server's key for this batch: the first request's subkey
            _, sub = jax.random.split(jax.random.PRNGKey(0))
            replay_draws(monkeypatch, jax_loop_draws(sub, WINDOWS, STEPS,
                                                     (MAX_BATCH, 1141, 1, 88)))
            argv += ["--device", "cpu"]
        cli.main(argv)
        runs[name] = (_lines(capsys.readouterr().out), poses)

    (jl, jposes), (tl, tposes) = runs["jax"], runs["torch"]
    for lines in (jl, tl):
        errors = [l for l in lines if "wav" in l and "error" in l]
        assert len(errors) == 1 and "NotAStyle" in errors[0]["error"]
        assert len([l for l in lines if "line" in l and "error" in l]) == 1
        closing = [l for l in lines if "served" in l]
        assert len(closing) == 1
        assert {k: closing[0][k] for k in ("served", "batches")} == {"served": 2, "batches": 1}
    # the port's closing line adds its server's counters: one batch of 16 rows, two of them
    # real, at the 2-window bucket
    assert [l for l in tl if "served" in l] == [
        {"served": 2, "batches": 1, "rows_padded": 14, "windows_encoded": 32,
         "windows_padding": 28, "requests_by_bucket": {"2": 2}}]
    jok = [l for l in jl if "out" in l]
    tok = [l for l in tl if "out" in l]
    assert [sorted(l) for l in jok] == [sorted(l) for l in tok]
    assert [l["frames"] for l in jok] == [l["frames"] for l in tok] == [152, 152]
    assert sorted(jposes) == sorted(tposes) and len(tposes) == 2
    for name in tposes:
        assert rel_err(tposes[name], jposes[name]) < 2e-3
    for j, t in zip(jok, tok):
        assert os.path.basename(j["out"]) == os.path.basename(t["out"])
        jv, tv = _bvh_values(j["out"]), _bvh_values(t["out"])
        assert jv.shape == tv.shape == (456, 75 * 3 + 3)
        diff = np.abs((tv - jv + 180.0) % 360.0 - 180.0)
        assert diff.max() / max(float(np.abs(jv).mean()), 1.0) < 2e-3


def test_serve_cli_interactive_request_response(tmp_path, capsys, monkeypatch):
    """A client that writes one request and blocks until its result arrives
    must get it: results are emitted by their own thread as each future
    resolves, not at the next input line or EOF."""
    from diffusestylegesture_torch.cli import serve as torch_serve
    from diffusestylegesture_torch.motion import zeggs_features as zf

    cfg_path, mdm_pt, wav = write_tiny_run(tmp_path, diffusion_steps=2, seconds=4)
    first_result = threading.Event()
    real = zf.pose_features_to_bvh

    def spy(*a, **kw):
        r = real(*a, **kw)
        first_result.set()
        return r

    monkeypatch.setattr(zf, "pose_features_to_bvh", spy)

    class InteractiveStdin:
        def __iter__(self):
            yield json.dumps({"wav": wav}) + "\n"
            assert first_result.wait(300), "no result while the client waits for it"
            yield json.dumps({"wav": wav, "out": str(tmp_path / "second.bvh")}) + "\n"

    monkeypatch.setattr(sys, "stdin", InteractiveStdin())
    res = torch_serve.main(["--config", cfg_path, "--model_path", mdm_pt, "--max_delay_ms", "50",
                            "--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    ok = [l for l in lines if "out" in l]
    assert len(ok) == 2 and all(os.path.exists(l["out"]) for l in ok)
    assert res["served"] == 2 and res["batches"] == 2


@pytest.mark.parametrize("extra", [["--serve_fast"], ["--crossfade_n", "-1", "--use_ema"]],
                         ids=["serve_fast", "quirk_ema"])
def test_serve_cli_options_on_cpu(tmp_path, capsys, extra):
    from diffusestylegesture_torch.cli import serve as torch_serve

    cfg_path, mdm_pt, wav = write_tiny_run(tmp_path, diffusion_steps=2, seconds=8)
    reqs = str(tmp_path / "reqs.jsonl")
    with open(reqs, "w") as f:
        f.write(json.dumps({"wav": wav, "style": [0.5, 0, 0, 0.5, 0, 0]}) + "\n")
        f.write(json.dumps({"wav": wav, "style": "Happy:0.6,Sad:0.4",
                            "out": str(tmp_path / "blend.bvh")}) + "\n")
    res = torch_serve.main(["--config", cfg_path, "--model_path", mdm_pt, "--requests", reqs,
                            "--max_batch", "4", "--max_delay_ms", "300", "--device", "cpu"]
                           + extra)
    ok = [l for l in _lines(capsys.readouterr().out) if "out" in l]
    assert [l["frames"] for l in ok] == [152, 152]
    assert res == {"served": 2, "batches": 1, "rows_padded": 2, "windows_encoded": 8,
                   "windows_padding": 4, "requests_by_bucket": {2: 2}, "capture_seconds": 0.0}
    assert os.path.getsize(tmp_path / "blend.bvh") > 0
