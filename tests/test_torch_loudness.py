"""The port's EBU R128 loudness module vs the JAX package's.

`diffusestylegesture_torch/audio/loudness.py` is the port's own copy of
`diffusestylegesture_tpu/audio/loudness.py` (the port imports nothing of the
JAX package); on a seeded wav, a loud clipped one, a short one and silence,
`integrated_loudness`, `true_peak_db` and `normalize_loudness` agree at 1e-6.
"""
import numpy as np
import pytest

from diffusestylegesture_tpu.audio import loudness as jax_loudness
from diffusestylegesture_torch.audio import loudness

SR = 16000.0


def _wavs():
    rng = np.random.default_rng(11)
    t = np.arange(int(SR * 3)) / SR
    speechy = (0.2 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
               + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    return {"seeded": speechy, "loud": np.clip(speechy * 8, -1, 1),
            "short": speechy[:3000], "silence": np.zeros(int(SR * 2), np.float32)}


@pytest.mark.parametrize("name", ["seeded", "loud", "short", "silence"])
def test_loudness_equals_jax(name):
    y = _wavs()[name]
    for fn in ("integrated_loudness", "true_peak_db"):
        a, b = getattr(loudness, fn)(y, SR), getattr(jax_loudness, fn)(y, SR)
        if np.isfinite(b):
            assert abs(a - b) <= 1e-6, (fn, a, b)
        else:
            assert a == b, (fn, a, b)
    out = loudness.normalize_loudness(y, SR)
    ref = jax_loudness.normalize_loudness(y, SR)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    if name == "seeded":  # the target is reached
        assert abs(loudness.integrated_loudness(out, SR) + 23.0) < 0.05
