"""Build and load the hand-written CUDA kernels.

Each source under ``lightgbm_tpu_torch/csrc/`` is compiled at first use,
on the machine with the card, by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, and loaded with ``ctypes``.  Libraries go
to ``lightgbm_tpu_torch/_build/`` under a name that carries a hash of the
source and of every header it includes from ``csrc/``, so an edited source
or header is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> source, relative to the package
KERNEL_SOURCES: Dict[str, str] = {
    "hist_gather": "csrc/hist_gather.cu",
    "hist_local": "csrc/hist_local.cu",
    "partition": "csrc/partition.cu",
    "cat_group": "csrc/cat_group.cu",
    "route": "csrc/route.cu",
    "lambdarank": "csrc/lambdarank.cu",
    "traverse": "csrc/traverse.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lightgbm_tpu_torch are built on the machine "
                           "with the card")
    return path


def _source_files(src: str) -> List[str]:
    """``src`` and every file it includes with ``#include "..."``, found
    beside the file that includes it, each once, in the order reached."""
    files, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            text = f.read()
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    return files


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(os.path.join(_PKG, KERNEL_SOURCES[name])):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:12]}.so")


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


def function(name: str, symbol: str,
             argtypes: Sequence) -> Callable[..., int]:
    """C entry point ``symbol`` of kernel ``name`` with its argument types
    declared and an ``int`` result, set up once per process."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn
