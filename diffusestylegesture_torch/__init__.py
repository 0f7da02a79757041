"""PyTorch + CUDA (Hopper) port of the DiffuseStyleGesture framework.

The JAX package `diffusestylegesture_tpu` is the reference; this package
never imports it (nor jax/flax/orbax). Its main paths are ZEGGS inference,
16 kHz wav → BVH, and BEAT/TWH serving, wav + word timings → motion, with
both of the reference's Pallas kernels replaced by hand-written CUDA kernels
for sm_90a (`csrc/`, bound in `ops/`).

Entry points default to ``device="cuda"`` and raise when no card is
present; the CPU runs only where the caller asks for it (the tests).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
