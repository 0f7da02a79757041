"""Host-side audio preparation: EBU R128 loudness (`loudness.py`) and the
Sphinx MFCC of the dataset preparation (`sphinx_mfcc.py`)."""
from .loudness import integrated_loudness, normalize_loudness, true_peak_db
from .sphinx_mfcc import sphinx_mfcc_energy

__all__ = ["integrated_loudness", "normalize_loudness", "sphinx_mfcc_energy", "true_peak_db"]
