"""Build and load the CUDA kernels of `slimm_tpu_torch/csrc/`.

`nvcc` compiles `csrc/hist.cu` into a shared library with a plain C
interface, under `slimm_tpu_torch/_build/`, named by a hash of the source,
at the first call of `load()`; `ctypes` loads it.  Nothing is built when the
package is imported, and a machine without `nvcc` gets an error, not a
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "hist.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (neither on PATH nor in CUDA_HOME/bin): "
                       "the CUDA histogram kernels cannot be built")


def library_path() -> str:
    """Where the library for the current source lives (built or not)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libslimm_hist_{digest}.so")


def build() -> str:
    """Compile the source unless the library for its hash exists."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: concurrent builders never see half a file
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = ctypes.CDLL(build())
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    plan = [ctypes.c_int] * 4      # ops/hist.py Plan: variant .. smem
    lib.slimm_hist1.argtypes = [p, p, i64, p, i32, *plan, p]
    lib.slimm_hist1.restype = ctypes.c_int
    lib.slimm_hist2.argtypes = [p, p, p, i64, p, p, p, i32, *plan, p]
    lib.slimm_hist2.restype = ctypes.c_int
    lib.slimm_hist_init.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.slimm_hist_init.restype = ctypes.c_int
    return lib
