"""Text-to-motion end to end: the JAX `train_t2m` -> the converter -> the port's
`generate`, against the JAX `generate`, and the port's own `train_t2m`.

On the toy corpus and widths of the JAX package's `tests/test_t2m_e2e.py`
(latent 32, 2 layers, CLIP width 32, 64 frames):

* the JAX `cli/train_t2m.py` writes its save dir (its caption encoder named
  only by a seed);
* `scripts/convert_orbax_to_torch.py` turns it into the port's save dir,
  the CLIP weights (the JAX `PRNGKey(seed)` init) included; the port's
  `generate` on the unconverted spec raises and names the converter;
* the port's `generate` and the JAX one run on the same draws (the JAX
  loop's, replayed into the port's program), in DDPM and in DDIM with
  respace: `results.npy` agrees within 2e-3 rel, its other fields equal;
* the port's `train_t2m --device cpu` runs a few steps to a save dir that its
  `generate` serves.
"""
import json
import os
import sys

import numpy as np
import pytest

import jax

from diffusestylegesture_tpu.cli import generate as jgen
from diffusestylegesture_tpu.cli import train_t2m as jtrain
from diffusestylegesture_torch.cli import generate as tgen
from diffusestylegesture_torch.cli import train_t2m as ttrain
from diffusestylegesture_torch.models.clip_text import SeedOnlyEncoderError

from torch_port_utils import jax_single_loop_draws, rel_err, replay_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import convert_orbax_to_torch  # noqa: E402

N_FRAMES, NJ, STEPS = 64, 263, 16
TRAIN_FLAGS = ["--latent_dim", "32", "--num_layers", "2", "--ff_size", "64",
               "--batch_size", "4", "--num_steps", "4", "--save_interval", "4",
               "--diffusion_steps", str(STEPS), "--num_frames", str(N_FRAMES), "--lr", "1e-3",
               "--clip_width", "32", "--clip_layers", "2", "--log_interval", "2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("t2m_cli")
    motion_dir, text_dir = root / "joint_vecs", root / "texts"
    motion_dir.mkdir(), text_dir.mkdir()
    rng = np.random.default_rng(0)
    captions = [("a person walks slowly", "walk/VERB slowly/ADV"),
                ("a person waves quickly", "wave/VERB quickly/ADV")]
    ids = []
    for i in range(8):
        name = f"{i:06d}"
        ids.append(name)
        length = int(rng.integers(48, 65))
        cls = i % 2
        t = np.arange(length)[:, None]
        base = np.sin(t * (0.1 + 0.2 * cls) + np.arange(NJ)[None] * 0.05)
        np.save(motion_dir / f"{name}.npy",
                (base + 0.1 * rng.standard_normal((length, NJ))).astype(np.float32))
        cap, toks = captions[cls]
        (text_dir / f"{name}.txt").write_text(f"{cap}#{toks}#0.0#0.0\n")
    (root / "train.txt").write_text("\n".join(ids))
    frames = np.concatenate([np.load(motion_dir / f"{n}.npy") for n in ids])
    np.save(root / "Mean.npy", frames.mean(0))
    np.save(root / "Std.npy", frames.std(0) + 1e-6)
    (root / "prompts.txt").write_text("a person walks slowly\na person waves quickly\n")
    return {"root": root, "flags": ["--motion_dir", str(motion_dir), "--text_dir", str(text_dir),
                                    "--split", str(root / "train.txt"),
                                    "--mean", str(root / "Mean.npy"),
                                    "--std", str(root / "Std.npy")]}


@pytest.fixture(scope="module")
def converted(corpus):
    jax_dir = str(corpus["root"] / "jax_save")
    jtrain.main(corpus["flags"] + ["--save_dir", jax_dir] + TRAIN_FLAGS)
    out = str(corpus["root"] / "port_save")
    written = convert_orbax_to_torch.convert(jax_dir, out)
    assert any(p.endswith("clip_text.npz") for p in written)
    return jax_dir, out


def test_seed_only_spec_raises_naming_the_converter(corpus, converted):
    jax_dir, _ = converted
    with pytest.raises(SeedOnlyEncoderError, match="convert_orbax_to_torch"):
        tgen.main(["--model_path", jax_dir, "--text_prompt", "a person walks",
                   "--device", "cpu"])


@pytest.mark.parametrize("sampler,respace", [("ddpm", 0), ("ddim", 8)])
def test_generate_matches_jax_on_the_same_draws(corpus, converted, monkeypatch, sampler,
                                                respace):
    jax_dir, port_dir = converted
    flags = ["--input_text", str(corpus["root"] / "prompts.txt"), "--motion_length",
             str(N_FRAMES / 20.0), "--num_repetitions", "2", "--guidance_param", "2.5",
             "--sampler", sampler, "--respace", str(respace), "--seed", "3", "--save_feats"]
    jout = jgen.main(["--model_path", jax_dir, "--output_dir",
                      str(corpus["root"] / f"jgen_{sampler}")] + flags)
    steps = respace or STEPS
    replay_draws(monkeypatch, [jax_single_loop_draws(jax.random.PRNGKey(3), steps,
                                                     (4, NJ, 1, N_FRAMES))])
    tout = tgen.main(["--model_path", port_dir, "--output_dir",
                      str(corpus["root"] / f"tgen_{sampler}"), "--device", "cpu"] + flags)
    jres = np.load(os.path.join(jout, "results.npy"), allow_pickle=True).item()
    tres = np.load(os.path.join(tout, "results.npy"), allow_pickle=True).item()
    assert tres["motion"].shape == jres["motion"].shape == (4, 22, 3, N_FRAMES)
    assert rel_err(tres["motion"], jres["motion"]) <= 2e-3
    for k in ("text", "num_samples", "num_repetitions"):
        assert tres[k] == jres[k]
    assert np.array_equal(tres["lengths"], jres["lengths"])
    assert rel_err(np.load(os.path.join(tout, "results_feats.npy")),
                   np.load(os.path.join(jout, "results_feats.npy"))) <= 2e-3
    assert open(os.path.join(tout, "results.txt")).read() == \
        open(os.path.join(jout, "results.txt")).read()


def test_port_trains_and_serves_on_the_cpu(corpus):
    save = str(corpus["root"] / "torch_save")
    run = ttrain.main(corpus["flags"] + ["--save_dir", save, "--device", "cpu"] + TRAIN_FLAGS)
    assert run["state"].step == 4
    assert os.path.exists(os.path.join(save, "4", "model_ema.pt"))
    with open(os.path.join(save, "t2m_config.json")) as f:
        spec = json.load(f)["clip"]
    assert spec["params_path"] == "clip_text.pt" and spec["width"] == 32
    out = tgen.main(["--model_path", save, "--text_prompt", "a person waves quickly",
                     "--motion_length", "2.0", "--num_repetitions", "2", "--sampler", "ddim",
                     "--respace", "4", "--use_ema", "--output_dir", str(corpus["root"] / "own"),
                     "--device", "cpu"])
    res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    assert res["motion"].shape == (2, 22, 3, 40) and np.isfinite(res["motion"]).all()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not __import__("torch").cuda.is_available():
            tgen.main(["--model_path", save, "--text_prompt", "a person"])
        else:
            raise RuntimeError("device='cpu'")
