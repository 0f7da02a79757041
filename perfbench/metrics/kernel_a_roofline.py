"""Kernel A's share of its roofline: the least time of its calls at the cell's
shape (perfbench/counts) over the device time of its kernel, in the
denoiser's replays of the traced slice."""
from perfbench.harness import readers

LAYER = "kernels: ops/local_attention.py + csrc/local_attention.cu"
UNIT = "%"
SOURCE = "device_trace"
PATTERN = r"^local_attention_kernel"


def read(ctx):
    return readers.kernel_roofline(ctx, "denoiser", PATTERN, PATTERN, "local_attention")
