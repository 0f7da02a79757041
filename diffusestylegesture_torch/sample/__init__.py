from .edit import ZEGGS_ROOT_CHANNELS, edit_motion, feature_mask, in_between_mask
from .engine import (
    ZeggsEngineConfig,
    ZeggsSampler,
    crossfade_weights,
    generate_multi_clip,
    make_mfcc_window_fn,
    slice_audio_windows,
    unnormalize_poses,
)
from .engine_beat import BeatEngineConfig, BeatTwhSampler, prepare_seed_gesture
from .engine_t2m import TextMotionSampler
from .restyle import restyle_window
from .server import GestureServer, ServerConfig
from .streaming import BeatTwhStreamSampler, ZeggsStreamSampler
from .styles import blend_styles, style_grid, style_vector

__all__ = ["BeatEngineConfig", "BeatTwhSampler", "BeatTwhStreamSampler", "GestureServer",
           "ServerConfig", "TextMotionSampler", "ZEGGS_ROOT_CHANNELS", "ZeggsEngineConfig",
           "ZeggsSampler", "ZeggsStreamSampler", "blend_styles", "crossfade_weights", "edit_motion",
           "feature_mask", "generate_multi_clip", "in_between_mask", "make_mfcc_window_fn", "prepare_seed_gesture",
           "restyle_window", "slice_audio_windows", "style_grid", "style_vector",
           "unnormalize_poses"]
