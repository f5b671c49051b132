"""Build-on-first-use for the port's CUDA kernels in ``paddle_tpu_torch/csrc``.

The idea of ``paddle_tpu/core/native_build.py`` (one place owns the
compiler line and the rebuild rule), carried over to ``nvcc``: each
``csrc/<name>.cu`` has a plain C interface and is compiled on its own into
``_build/lib<name>-<hash>.so``, where the hash covers the source, every
header in ``csrc/`` and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The library is loaded with ``ctypes``;
callers declare every pointer and the stream as ``c_void_p``.

Nothing is built when the module is imported. ``build(names)`` starts one
``nvcc`` per source, all at once, and waits for them; a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: per kernel source: {"seconds": build time (0.0 when cached), "log": the
#: compiler's output, which holds ptxas's register/shared-memory lines}
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built on the GPU machine")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC_DIR)):
        if fn == name + ".cu" or fn.endswith((".cuh", ".h")):
            with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every stale ``csrc/<name>.cu`` in parallel; returns
    {name: library path}. Raises on the first failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, so in paths.items():
        if os.path.exists(so):
            build_info.setdefault(n, {"seconds": 0.0, "log": ""})
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        build_info[n] = {"seconds": time.perf_counter() - t0, "log": out}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu "
                          f"(rc={proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib
