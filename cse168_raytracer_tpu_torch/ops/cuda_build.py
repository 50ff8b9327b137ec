"""Build and load the port's CUDA kernels.

Each kernel source under cse168_raytracer_tpu_torch/csrc/ is compiled by
`nvcc` for Hopper (sm_90a) into a shared library with a plain C
interface, loaded with ctypes. The build happens at first use, into
cse168_raytracer_tpu_torch/_build/<hash>/, keyed on a hash of the
source, the shared headers (csrc/*.cuh) and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# every kernel source of the port
SOURCES = ("traverse_wide.cu", "traverse_binary.cu", "tri_blocks.cu")

# the plain builds (no `defines`) this process used: {source: {"seconds",
# "log", "path"}}, "seconds" None where the library was already built;
# "log" is nvcc's output (its -Xptxas -v report), kept beside the library
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build_library(source: str, defines: tuple = ()) -> str:
    """Compile csrc/<source> (if not already built), with the macros
    `defines` set, and return the path of its shared library."""
    src_path = os.path.join(CSRC, source)
    flags = NVCC_FLAGS + tuple("-D" + m for m in defines)
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    key = digest.hexdigest()[:16]
    out_dir = os.path.join(BUILD, key)
    stem = "lib" + os.path.splitext(source)[0]
    lib = os.path.join(out_dir, stem + ".so")
    log_path = os.path.join(out_dir, stem + ".log")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib) and os.path.exists(log_path):
            if not defines:
                with open(log_path) as f:
                    BUILD_INFO.setdefault(source, {"seconds": None,
                                                   "log": f.read(),
                                                   "path": lib})
            return lib
        t0 = time.perf_counter()
        tmp = lib + ".tmp"
        res = subprocess.run([find_nvcc(), *flags, "-o", tmp, src_path],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n"
                               f"{res.stdout}\n{res.stderr}")
        with open(log_path, "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, lib)
        if not defines:
            BUILD_INFO[source] = {"seconds": time.perf_counter() - t0,
                                  "log": res.stdout + res.stderr, "path": lib}
    return lib


def load_library(source: str, defines: tuple = ()) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(source, defines))


def build_all(sources=SOURCES) -> dict:
    """Build every kernel source at once, one nvcc process each, all
    started together. Returns {source: library path}; raises the first
    failure."""
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(build_library, sources)))
