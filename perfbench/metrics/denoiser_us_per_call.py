"""Device microseconds of the denoiser's CUDA-graph replays per call (one kernel-A launch a call), over the traced slice."""
from perfbench.harness import readers

LAYER = "denoiser: models/mdm.py, models/mdm_plus.py via diffusion/sampling.py"
UNIT = "us"
SOURCE = "device_trace"


def read(ctx):
    return readers.denoiser_us_per_call(ctx)
