"""Device microseconds of WavLM's replays per window encoded (batch rows x bucket windows), over the traced slice."""
from perfbench.harness import readers

LAYER = "audio encoder: models/wavlm via ZeggsSampler.encode"
UNIT = "us"
SOURCE = "device_trace"


def read(ctx):
    return readers.wavlm_us_per_window(ctx)
