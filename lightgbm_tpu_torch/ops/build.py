"""Build and load the hand-written CUDA kernels.

Each source under ``lightgbm_tpu_torch/csrc/`` is compiled at first use,
on the machine with the card, by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, and loaded with ``ctypes``.  Libraries go
to ``lightgbm_tpu_torch/_build/`` under a name that carries a hash of the
source, so an edited source is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> source, relative to the package
KERNEL_SOURCES: Dict[str, str] = {
    "hist_gather": "csrc/hist_gather.cu",
    "partition": "csrc/partition.cu",
    "cat_group": "csrc/cat_group.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lightgbm_tpu_torch are built on the machine "
                           "with the card")
    return path


def library_path(name: str) -> str:
    src = os.path.join(_PKG, KERNEL_SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def _start_build(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(_PKG, KERNEL_SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: str,
                  out: str) -> str:
    log_text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log_text}")
    os.replace(tmp, out)
    return log_text


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together; returns each build's compiler output
    (registers and shared memory per kernel, from ``-Xptxas=-v``)."""
    names = list(KERNEL_SOURCES) if names is None else names
    with _lock:
        procs = {n: _start_build(n) for n in names
                 if not os.path.exists(library_path(n))}
        return {n: _finish_build(n, p, tmp, out)
                for n, (p, tmp, out) in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build_all([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(path)
                _loaded[name] = lib
    return lib
