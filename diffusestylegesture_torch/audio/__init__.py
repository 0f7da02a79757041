"""Host-side audio preparation: EBU R128 loudness (`loudness.py`), the
Sphinx MFCC of the dataset preparation (`sphinx_mfcc.py`), and the BEAT/TWH
per-frame features (MFCC, log-mel, prosody from the praat port in
`praat_pitch.py`, onsets; `features.py`), whose onsets the beat-alignment
metric uses too."""
from .features import detect_onsets
from .loudness import integrated_loudness, normalize_loudness, true_peak_db
from .sphinx_mfcc import sphinx_mfcc_energy

__all__ = ["detect_onsets", "integrated_loudness", "normalize_loudness", "sphinx_mfcc_energy",
           "true_peak_db"]
