"""Hand-written CUDA kernels (`csrc/`) and their PyTorch wrappers.

Nothing here builds or loads a kernel at import time; see `build.py`.
"""
