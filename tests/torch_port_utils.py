"""Shared helpers of the PyTorch-port parity tests (`test_torch_*.py`)."""
import math

import numpy as np
import torch


def randomize_flax_params(tree, seed: int):
    """Replace every leaf of a flax param tree with seeded random values so
    that biases and norm parameters (zero/one at init) are exercised too:
    kernels ~ N(0, 1/fan_in), scales ~ 1 + 0.1·N, everything else 0.1·N."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(a)
        n = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return n / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        if "scale" in name or name == "grep_a":
            return 1.0 + 0.1 * n
        if name == "relative_attention_bias":
            return 0.5 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def np32(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def twh_parents():
    """{bone: parent} of a plausible tree over the 62 TWH bones: legs and the
    spine hang from b_root, the arms from b_spine3, each finger chain from
    its wrist, every other bone from the bone listed before it."""
    from diffusestylegesture_torch.motion.pipeline import TWH_BONE_NAMES

    parents = {"body_world": None}
    for prev, name in zip(TWH_BONE_NAMES, TWH_BONE_NAMES[1:]):
        side = name[2:3]
        if name.endswith(("upleg", "spine0")):
            parents[name] = "b_root"
        elif name.endswith("shoulder"):
            parents[name] = "b_spine3"
        elif name.endswith(("thumb0", "index1", "middle1", "ring1", "pinky1")):
            parents[name] = f"b_{side}_wrist"
        else:
            parents[name] = prev
    return parents


def synth_twh62_bvh(path, T=48, fps=30, seed=0):
    """A BVH of the full 62-bone TWH skeleton, 6 channels a bone
    ([XYZ position | ZXY rotation], the GENEA layout, so `twh_features` is
    744 wide), an End Site under each leaf, seeded smooth-ish random values."""
    from diffusestylegesture_torch.motion import pipeline as P

    rng = np.random.default_rng(seed)
    parents = twh_parents()
    joints = list(parents)
    chans = ["Xposition", "Yposition", "Zposition", "Zrotation", "Xrotation", "Yrotation"]
    channels = {j: list(chans) for j in joints}
    leaves = [j for j in joints if j not in set(parents.values())]
    for leaf in leaves:
        parents[leaf + "_Nub"] = leaf
        channels[leaf + "_Nub"] = []
    names = list(parents)
    offsets = {n: rng.uniform(-5, 5, 3).astype(np.float32) for n in names}
    columns = [f"{j}_{c}" for j in joints for c in chans]
    t = np.arange(T)[:, None] / fps
    C = len(columns)
    vals = rng.uniform(-60, 60, (1, C)) * np.sin(
        2 * np.pi * rng.uniform(0.1, 1.0, (1, C)) * t + rng.uniform(0, 6, (1, C)))
    data = P.ChannelData(names, parents, offsets, channels, columns, vals, 1.0 / fps, "body_world")
    P.write_bvh_channels(data, path)
    return data


def synth_beat_full_bvh(path, T=121, fps=120, seed=0):
    """A BEAT BVH of Hips (6 channels) + the 74 `BEAT_TARGET_JOINTS` + one
    non-target joint (3 rotation channels each), chained, so `beat_features`
    is 684 wide."""
    from diffusestylegesture_torch.motion import pipeline as P

    rng = np.random.default_rng(seed)
    joints = ["Hips"] + list(P.BEAT_TARGET_JOINTS) + ["Extra1"]
    parents = {"Hips": None}
    for prev, name in zip(joints, joints[1:]):
        parents[name] = prev
    channels = {j: ["Xrotation", "Yrotation", "Zrotation"] for j in joints}
    channels["Hips"] = ["Xposition", "Yposition", "Zposition"] + channels["Hips"]
    parents[joints[-1] + "_Nub"] = joints[-1]
    channels[joints[-1] + "_Nub"] = []
    names = list(parents)
    offsets = {n: rng.uniform(-3, 3, 3).astype(np.float32) for n in names}
    columns = [f"{j}_{c}" for j in joints for c in channels[j]]
    vals = rng.uniform(-40, 40, (T, len(columns)))
    vals[:, 0:3] = rng.uniform(-10, 10, (T, 3)) + [0, 90, 0]
    data = P.ChannelData(names, parents, offsets, channels, columns, vals, 1.0 / fps, "Hips")
    P.write_bvh_channels(data, path)
    return data


def interpolation_rounding_bar(raw) -> float:
    """How far two float32 linear interpolations of the (T', C) rows `raw` to
    another length may drift apart when their source positions (up to T' − 1)
    are rounded one ulp apart: that ulp times the largest frame-to-frame step.
    XLA's compiled `jnp.linspace` and the port's `interpolate_linear` round
    some positions so (ROADMAP §3)."""
    raw = np.asarray(raw, np.float64)
    return float(np.spacing(np.float32(len(raw) - 1)) * np.abs(np.diff(raw, axis=0)).max())


ZEGGS_TINY_NJ = 32
ZEGGS_TINY_MDM = dict(njoints=ZEGGS_TINY_NJ, latent_dim=96, ff_size=64, num_layers=2, n_seed=8)
ZEGGS_TINY_WAVLM = dict(
    encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=48, encoder_attention_heads=4,
    conv_pos=8, conv_pos_groups=4, num_buckets=40, max_distance=80,
    conv_feature_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                         (16, 2, 2), (16, 2, 2)),
)


def zeggs_tiny_pair(seed: int = 0):
    """A tiny ZEGGS MDM and WavLM on shared weights: flax init, randomized,
    crossed into the port through `models/convert.py`. Returns the flax
    modules and params (`fm`, `mparams`, `fw`, `wparams`), the port's eval-mode
    modules on the CPU (`mdm`, `wavlm`) and seeded stats (`mean`, `std`)."""
    import jax
    import jax.numpy as jnp

    from diffusestylegesture_tpu.models.mdm import MDM as FlaxMDM, MDMConfig as FlaxMDMConfig
    from diffusestylegesture_tpu.models.wavlm import WavLM as FlaxWavLM
    from diffusestylegesture_tpu.models.wavlm import WavLMConfig as FlaxWavLMConfig
    from diffusestylegesture_torch.models.convert import (
        mdm_state_dict_from_flax,
        wavlm_state_dict_from_flax,
    )
    from diffusestylegesture_torch.models.mdm import MDM, MDMConfig
    from diffusestylegesture_torch.models.wavlm import WavLM, WavLMConfig

    nj, n_poses, n_seed = ZEGGS_TINY_NJ, 88, ZEGGS_TINY_MDM["n_seed"]
    fw = FlaxWavLM(FlaxWavLMConfig(**ZEGGS_TINY_WAVLM))
    wparams = jax.jit(fw.init)(jax.random.PRNGKey(seed + 1), jnp.zeros((1, 16000)))
    wparams = {"params": randomize_flax_params(wparams["params"], seed + 1)}
    fm = FlaxMDM(FlaxMDMConfig(**ZEGGS_TINY_MDM))
    x = jnp.zeros((1, nj, 1, n_poses))
    cond = {"style": jnp.zeros((1, 6)), "seed": x[..., :n_seed],
            "audio": jnp.zeros((1, n_poses, ZEGGS_TINY_WAVLM["encoder_embed_dim"])),
            "mask_local": jnp.ones((1, n_poses), bool)}
    mparams = jax.jit(fm.init)(jax.random.PRNGKey(seed + 2), x, jnp.zeros((1,), jnp.int32), cond)
    mparams = {"params": randomize_flax_params(mparams["params"], seed + 2)}
    wavlm = WavLM(WavLMConfig(**ZEGGS_TINY_WAVLM)).eval()
    wavlm.load_state_dict(wavlm_state_dict_from_flax(wparams, WavLMConfig(**ZEGGS_TINY_WAVLM)))
    mdm = MDM(MDMConfig(**ZEGGS_TINY_MDM,
                        audio_in_dim=ZEGGS_TINY_WAVLM["encoder_embed_dim"])).eval()
    mdm.load_state_dict(mdm_state_dict_from_flax(mparams))
    rng = np.random.default_rng(seed)
    return dict(fw=fw, wparams=wparams, fm=fm, mparams=mparams, wavlm=wavlm, mdm=mdm,
                mean=rng.standard_normal(nj).astype(np.float32),
                std=(0.5 + rng.random(nj)).astype(np.float32))


def jax_loop_draws(key, num_windows: int, steps: int, shape):
    """Each window's draws in the JAX engine's loop for `key`, x_T first: the
    engine splits a subkey per window; the loop splits it into (key,
    init_key), draws x_T from init_key and then one array a step."""
    import jax
    import jax.numpy as jnp

    out = []
    for _ in range(num_windows):
        key, sub = jax.random.split(key)
        sub, init_key = jax.random.split(sub)
        draws = [np.array(jax.random.normal(init_key, shape, dtype=jnp.float32))]
        for _ in range(steps):
            sub, nkey = jax.random.split(sub)
            draws.append(np.array(jax.random.normal(nkey, shape, dtype=jnp.float32)))
        out.append(draws)
    return out


def replay_draws(monkeypatch, windows):
    """Make each window's program (one `init` a window) draw the given arrays
    in order, x_T first (unless `init` is handed its noise)."""
    from diffusestylegesture_torch.diffusion.sampling import SampleProgram

    pending = iter(windows)
    init = SampleProgram.init

    def init_with_draws(self, noise=None, init_image=None):
        self._draws = iter(next(pending))
        init(self, noise, init_image)

    monkeypatch.setattr(SampleProgram, "init", init_with_draws)
    monkeypatch.setattr(SampleProgram, "_randn", lambda self: torch.from_numpy(next(self._draws)))


def rel_err(out, ref) -> float:
    """max |out − ref| over max(mean |ref|, 1): the windowed engines' bar is 2e-3."""
    out, ref = np32(out), np32(ref)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).mean()), 1.0)


def jax_single_loop_draws(key, steps: int, shape):
    """The draws of one JAX sampling loop called with `key` directly (no
    window split, as the JAX `cli/generate.py` calls it), x_T first: the loop
    splits `key` into (key, init_key), draws x_T from init_key and then one
    array a step."""
    import jax
    import jax.numpy as jnp

    key, init_key = jax.random.split(key)
    draws = [np.array(jax.random.normal(init_key, shape, dtype=jnp.float32))]
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        draws.append(np.array(jax.random.normal(nkey, shape, dtype=jnp.float32)))
    return draws


class PerStep:
    """A denoiser called as itself but without its `cond_invariants`: a
    window engine handed it computes the conditioning at every step, the
    path a model without invariants takes."""

    def __init__(self, model):
        self.model = model

    def __call__(self, *args, **kwargs):
        return self.model(*args, **kwargs)
