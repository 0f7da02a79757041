"""Device microseconds of the text-to-motion denoiser's CUDA-graph replays per
guided call, over the traced slice: the replays' busy time in the `denoiser`
span over the calls, one call being `num_layers` kernel-B attention grids
(each guided call runs the trunk once over the cond and uncond rows)."""
from perfbench.harness.profiling import kernel_seconds

LAYER = "denoiser: models/mdm_text.py via sample/engine_t2m.py"
UNIT = "us"
SOURCE = "device_trace"


def read(ctx):
    rec = None if ctx.reduced is None else ctx.reduced.layers.get("denoiser")
    if rec is None:
        return None
    grids, _ = kernel_seconds(rec, r"^encoder_layer_attention")
    calls = grids / ctx.system.cfg["num_layers"]
    return 1e6 * rec["graph_seconds"] / calls if calls else None
