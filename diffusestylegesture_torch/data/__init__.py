from .zeggs import ZeggsWindowDataset, build_zeggs_dataset, load_wav_16k

__all__ = ["ZeggsWindowDataset", "build_zeggs_dataset", "load_wav_16k"]
