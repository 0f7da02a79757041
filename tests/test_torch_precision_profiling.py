"""`utils/precision.py` and `utils/profiling.py` of the PyTorch port, on the CPU.

`bf16_cast` casts float32 tensors of a nested structure to bfloat16 and leaves
every other dtype and non-tensor alone, as the JAX `bf16_cast` does to its
pytree leaves (held against it on the same values); the WavLM loader's bf16
mode goes through it. `trace_capture` writes a trace file that shows the
program's spans (`tests/test_torch_tracing.py` holds the span API).
"""
import os

import numpy as np
import torch

import jax.numpy as jnp

from diffusestylegesture_tpu.utils import precision as jax_precision
from diffusestylegesture_torch.utils import profiling
from diffusestylegesture_torch.utils.precision import bf16_cast


def test_bf16_cast_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    i = np.arange(4, dtype=np.int32)
    tree = {"w": torch.from_numpy(a),
            "n": [torch.from_numpy(i), (torch.ones(2, dtype=torch.float64), 3)], "name": "x"}
    out = bf16_cast(tree)
    ref = jax_precision.bf16_cast({"w": jnp.asarray(a), "n": [jnp.asarray(i)]})
    assert out["w"].dtype == torch.bfloat16 and ref["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(), np.asarray(ref["w"], np.float32))
    assert out["n"][0].dtype == torch.int32 and out["n"][1][0].dtype == torch.float64
    assert out["n"][1][1] == 3 and out["name"] == "x"
    assert isinstance(out["n"], list) and isinstance(out["n"][1], tuple)


def test_trace_capture_writes_a_trace(tmp_path):
    with profiling.trace_capture(str(tmp_path)):
        with profiling.span("traced_scope"):
            torch.ones(8).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path) for f in fs]
    assert files and any("traced_scope" in open(f, errors="ignore").read() for f in files)
    profiling.clear()
