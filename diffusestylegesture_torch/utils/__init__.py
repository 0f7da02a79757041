"""Run-time utilities: CUDA graphs over the sampler (`graphs.py`), the bf16
cast of serving weights (`precision.py`) and the scope profiler
(`profiling.py`)."""
