from .engine import (
    ZeggsEngineConfig,
    ZeggsSampler,
    crossfade_weights,
    generate_multi_clip,
    slice_audio_windows,
    unnormalize_poses,
)

__all__ = ["ZeggsEngineConfig", "ZeggsSampler", "crossfade_weights", "generate_multi_clip",
           "slice_audio_windows",
           "unnormalize_poses"]
