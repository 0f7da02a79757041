from .engine import (
    ZeggsEngineConfig,
    ZeggsSampler,
    crossfade_weights,
    generate_multi_clip,
    slice_audio_windows,
    unnormalize_poses,
)
from .engine_beat import BeatEngineConfig, BeatTwhSampler, prepare_seed_gesture

__all__ = ["BeatEngineConfig", "BeatTwhSampler", "ZeggsEngineConfig", "ZeggsSampler",
           "crossfade_weights", "generate_multi_clip", "prepare_seed_gesture",
           "slice_audio_windows", "unnormalize_poses"]
