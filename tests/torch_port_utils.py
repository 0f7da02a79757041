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
