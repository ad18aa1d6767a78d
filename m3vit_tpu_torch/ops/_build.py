"""Builds the hand-written CUDA kernels and counts their launches.

Each ``m3vit_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  All
sources compile in parallel, once, at the first kernel call (or at
``build_all()``), into ``m3vit_tpu_torch/_build/<hash>/``, where the hash
covers the sources and the compiler flags.  Nothing is compiled when the
package is imported, and a failed build raises with the compiler's output.

A wrapper binds its C entry point once with ``bind`` (argument types set at
first use) and launches it with ``call`` on the tensor's current stream.
``launches`` counts, per kernel, the launches its wrapper made; a run resets
it with ``reset_launches()`` to show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: kernel name (== source stem) -> launches made by its wrapper
launches: Dict[str, int] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in kernel_names():
        launches[name] = 0


def kernel_names():
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    cands += [os.path.join(h, "bin", "nvcc")
              for h in (cuda_home, "/usr/local/cuda") if h]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin);"
        " the CUDA toolkit is needed to build the port's kernels")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, float]:
    """Compile every source not yet built, all in parallel; returns the
    seconds each compile took (empty when everything was built before)."""
    with _lock:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src in sorted(CSRC_DIR.glob("*.cu")):
            lib = out / f"{src.stem}.so"
            if lib.exists():
                continue
            tmp = out / f"{src.stem}.so.tmp{os.getpid()}"
            log = open(out / f"{src.stem}.log", "w")
            procs[src.stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT), tmp, lib, log,
                time.perf_counter())
        seconds, failed = {}, []
        for name, (proc, tmp, lib, log, t0) in procs.items():
            rc = proc.wait()
            log.close()
            seconds[name] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, lib)
            else:
                failed.append(
                    f"{name} (rc {rc}):\n{(out / f'{name}.log').read_text()}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return seconds


def compile_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) for `name`."""
    p = build_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, building on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build_dir() / f"{name}.so"))
                _libs[name] = lib
    return lib


def bind(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `name` of library `name` with its argument types set,
    built and bound once (a call then does no ctypes set-up)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(name), name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[name] = fn
    return fn


def call(fn, device, *args) -> int:
    """fn(*args, stream) on `device`'s current CUDA stream.  The device guard
    is entered only when `device` is not the current one: it costs more host
    time than the shortest kernels take."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def check(err: int, name: str, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err} "
                           f"({what})")
