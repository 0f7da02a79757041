"""Datasets: ZEGGS windows (`zeggs.py`), BEAT/TWH clip assembly (`beat_twh.py`),
its store and loader (`h5_loader.py`), word-timed text rows (`text.py`), BEAT
BVH repair and auxiliary IO (`bvh_repair.py`, `beat_proc.py`), the
training data kept on the card (`device_cache.py`) and the ZeroEGGS RNN
system's features (`zeroeggs_data.py`)."""
from .beat_twh import build_beat_twh_clip, load_audio_features, load_metadata, textgrid_to_tsv
from .h5_loader import SpeechGestureDataset, build_h5_dataset, gesture_statistics
from .zeggs import ZeggsWindowDataset, build_zeggs_dataset, load_wav_16k

__all__ = ["SpeechGestureDataset", "ZeggsWindowDataset", "build_beat_twh_clip",
           "build_h5_dataset", "build_zeggs_dataset", "gesture_statistics",
           "load_audio_features", "load_metadata", "load_wav_16k", "textgrid_to_tsv"]
