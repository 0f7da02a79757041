"""Training: the train state and step (`state.py`), the loop (`loop.py`),
checkpoints (`checkpoint.py`) and the logger (`logger.py`)."""
from .checkpoint import CheckpointManager, load_params_npz, save_params_npz
from .logger import KVLogger
from .loop import LoopConfig, TrainLoop
from .state import (AdamW, FlatParams, TrainConfig, TrainState, make_beat_cond_builder,
                    make_train_step, make_zeggs_cond_builder, zeggs_cond_builder)

__all__ = ["AdamW", "CheckpointManager", "FlatParams", "KVLogger", "LoopConfig", "TrainConfig",
           "TrainLoop", "TrainState", "load_params_npz", "make_beat_cond_builder",
           "make_train_step", "make_zeggs_cond_builder", "save_params_npz", "zeggs_cond_builder"]
