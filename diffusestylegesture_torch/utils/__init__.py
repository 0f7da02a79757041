"""Run-time utilities: CUDA graphs over the sampler (`graphs.py`)."""
