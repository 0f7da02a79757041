from .adapters import make_twh_wavlm_fn, make_zeggs_wavlm_fn
from .model import WavLM, WavLMConfig, interpolate_linear, relative_position_bucket

__all__ = ["WavLM", "WavLMConfig", "interpolate_linear", "make_twh_wavlm_fn",
           "make_zeggs_wavlm_fn", "relative_position_bucket"]
