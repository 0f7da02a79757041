"""Host-side audio preparation: EBU R128 loudness (`loudness.py`)."""
from .loudness import integrated_loudness, normalize_loudness, true_peak_db

__all__ = ["integrated_loudness", "normalize_loudness", "true_peak_db"]
