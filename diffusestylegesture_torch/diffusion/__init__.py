from .gaussian import LossKind, MeanType, VarType, p_mean_variance, q_sample, training_losses
from .sampling import (
    SamplerConfig,
    cfg_combine,
    ddim_reverse_sample,
    ddim_reverse_sample_loop,
    ddim_sample_loop,
    dpmpp2m_sample_loop,
    make_cfg_model_fn,
    p_sample_loop,
    plms_sample_loop,
)
from .schedule import Schedule, named_beta_schedule, space_timesteps, spaced_schedule

__all__ = [
    "LossKind", "MeanType", "VarType", "p_mean_variance", "q_sample", "training_losses",
    "SamplerConfig",
    "cfg_combine", "ddim_reverse_sample", "ddim_reverse_sample_loop", "ddim_sample_loop",
    "dpmpp2m_sample_loop", "make_cfg_model_fn",
    "p_sample_loop", "plms_sample_loop", "Schedule", "named_beta_schedule",
    "space_timesteps", "spaced_schedule",
]
