"""Host-side audio preparation: EBU R128 loudness (`loudness.py`), the
Sphinx MFCC of the dataset preparation (`sphinx_mfcc.py`) and the onsets of
the beat-alignment metric (`features.py`)."""
from .features import detect_onsets
from .loudness import integrated_loudness, normalize_loudness, true_peak_db
from .sphinx_mfcc import sphinx_mfcc_energy

__all__ = ["detect_onsets", "integrated_loudness", "normalize_loudness", "sphinx_mfcc_energy",
           "true_peak_db"]
