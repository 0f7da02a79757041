"""Gesture evaluation: FGD, diversity, multimodality and beat alignment
(`metrics.py`), KID and precision/recall (`unconstrained.py`), and the
autoencoder embedding FGD is computed in (`embedding.py`)."""
from .metrics import beat_alignment, diversity, frechet_distance, multimodality
from .unconstrained import kid, precision_and_recall

__all__ = ["beat_alignment", "diversity", "frechet_distance", "kid", "multimodality",
           "precision_and_recall"]
