from .zeggs import load_wav_16k

__all__ = ["load_wav_16k"]
