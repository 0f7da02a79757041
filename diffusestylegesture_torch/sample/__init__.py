from .engine import (
    ZeggsEngineConfig,
    ZeggsSampler,
    crossfade_weights,
    slice_audio_windows,
    unnormalize_poses,
)

__all__ = ["ZeggsEngineConfig", "ZeggsSampler", "crossfade_weights", "slice_audio_windows",
           "unnormalize_poses"]
