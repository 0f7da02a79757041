"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `_build/lib<name>-<hash>.so` (the hash is of the source and the
flags, so an edited source rebuilds). Nothing is built at import: a
kernel's library is built at its first launch, or up front, all sources
at once, by `build_all()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("local_attention", "encoder_layer")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, by source name
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_out, proc.final_out, proc.src_name = tmp, out, name
    return proc


def _finish(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[proc.src_name] = log
    if proc.returncode != 0:
        os.unlink(proc.tmp_out)
        raise RuntimeError(f"nvcc failed for {proc.src_name}.cu:\n{log}")
    os.replace(proc.tmp_out, proc.final_out)  # atomic: a reader never sees half a file


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile every listed source that is not built yet, one nvcc each, all at once."""
    names = tuple(SOURCES if names is None else names)
    with _lock:
        procs = [_start(n, _lib_path(n)) for n in names if not os.path.exists(_lib_path(n))]
        errors = []
        for p in procs:
            try:
                _finish(p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib
