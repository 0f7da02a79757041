"""Kernel B's share of its roofline: the least time of its calls at the cell's
shape (perfbench/counts) over the device time of its grids, in the
denoiser's replays of the traced slice. One attention grid marks one call."""
from perfbench.harness import readers

LAYER = "kernels: ops/encoder_layer.py + csrc/encoder_layer.cu"
UNIT = "%"
SOURCE = "device_trace"
PATTERN = r"^encoder_layer_"
CALLS = r"^encoder_layer_attention"


def read(ctx):
    return readers.kernel_roofline(ctx, "denoiser", PATTERN, CALLS, "encoder_layer")
