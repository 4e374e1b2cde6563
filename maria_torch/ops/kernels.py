"""Build and load the hand-written CUDA kernels (``maria_torch/csrc``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes, at first use: one nvcc per
source, all started together, then one link. The library lands in
``<repo>/build/maria_torch/`` under a name keyed by a hash of the sources
and flags, so a changed source never loads a stale build; the build
writes a private temporary directory and renames the library into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import cache

import numpy as np

__all__ = ["load", "build", "library_path", "scalar_reciprocal"]

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE_DIR, "csrc")
SOURCES = ("pink_noise.cu", "bin_map.cu", "shared_v.cu", "ar_extrude.cu", "sht.cu", "pink_cascade.cu", "los_sample.cu",
           "pixel_ids.cu", "band_tables.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def scalar_reciprocal(x: float) -> float:
    """The float32 factor by which torch divides a CUDA float32 tensor by
    the Python scalar ``x``: 1 / x taken in double, then rounded (not
    1 / float32(x); checked on the H100 with torch 2.11). A kernel that
    must be bit-equal to such a division multiplies by it."""
    return float(np.float32(1.0 / float(x)))


def _build_dir() -> str:
    return os.path.join(os.path.dirname(PACKAGE_DIR), "build", "maria_torch")


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(_build_dir(), f"libmaria_torch_kernels_{digest.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the kernels if this source version is not built yet.
    Returns {"path", "seconds", "log"} (log: nvcc's -Xptxas -v report)."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": "(cached)"}
    os.makedirs(_build_dir(), exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_build_dir()) as tmp:
        objects = [os.path.join(tmp, f"{os.path.splitext(name)[0]}.o") for name in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name), "-o", obj],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, obj in zip(SOURCES, objects)
        ]
        logs = []
        for name, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{err}")
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objects],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(lib, path)
    return {"path": path, "seconds": time.perf_counter() - start, "log": "".join(logs)}


@cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    lib = ctypes.CDLL(build()["path"])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.maria_pink_noise.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.maria_pink_noise.restype = i
    lib.maria_bin_map.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, i, ll, i, ll, p]
    lib.maria_bin_map.restype = i
    lib.maria_shared_v.argtypes = [p, p, p, i, i, i, ll, ctypes.c_uint, i, p]
    lib.maria_shared_v.restype = i
    lib.maria_ar_extrude.argtypes = [p, i, p, p, p, p, p, i, i, i, p]
    lib.maria_ar_extrude.restype = i
    lib.maria_ar_probe.argtypes = [i, i, i, i, p, p]
    lib.maria_ar_probe.restype = i
    lib.maria_sht_synth.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.maria_sht_synth.restype = i
    lib.maria_sht_anal.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.maria_sht_anal.restype = i
    lib.maria_sht_max_rings.argtypes = []
    lib.maria_sht_max_rings.restype = i
    lib.maria_pink_cascade.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.maria_pink_cascade.restype = i
    lib.maria_los_sample.argtypes = [p, i, ctypes.c_float, p, p, p, ll, ll, i, p, p]
    lib.maria_los_sample.restype = i
    lib.maria_los_sample_backward.argtypes = [p, i, p, p, p, ll, ll, i, p, p, p, p]
    lib.maria_los_sample_backward.restype = i
    lib.maria_los_max_layers.argtypes = []
    lib.maria_los_max_layers.restype = i
    lib.maria_los_layer_bytes.argtypes = []
    lib.maria_los_layer_bytes.restype = i
    f = ctypes.c_float
    lib.maria_pixel_ids.argtypes = [p, p, p, p, p, i, i, f, f, f, f, f, f, f, i, i, p, p]
    lib.maria_pixel_ids.restype = i
    lib.maria_band_tables.argtypes = [p, i, i, i, p, p, ll, p, ll, p, i, p, ll, p]
    lib.maria_band_tables.restype = i
    for name in ("maria_band_tables_desc_bytes", "maria_band_tables_max_bands", "maria_band_tables_smem_floats"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.maria_max_dynamic_smem.argtypes = [i]
    lib.maria_max_dynamic_smem.restype = i
    lib.maria_cuda_error_string.argtypes = [i]
    lib.maria_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} ({lib.maria_cuda_error_string(code).decode()})")
