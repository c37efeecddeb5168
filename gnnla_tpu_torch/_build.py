"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process, all started together,
for `sm_90a`; the objects are linked into one shared library with a plain
`extern "C"` interface, loaded with ctypes. No PyTorch headers and no
`ninja` are involved, so a build takes seconds.

The library lands in `_build/` beside this file (git-ignored), named by a
hash of the sources and flags, so a stale build is never loaded. Nothing
is built at import: the first call to `load()` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("dia_spmv.cu", "csr_spmv.cu", "csr_spmm.cu", "stencil.cu",
           "health.cu", "ellw_spmv.cu", "gather_probe.cu", "csr_ablate.cu")
HEADERS = ("csr_spmv_body.cuh",)  # included by sources: in the hash
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_info: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _compile(nvcc: str, lib_path: str, log_path: str) -> List[str]:
    """Compile every source in parallel, link, and return the ptxas
    report lines (registers, shared memory, stack and spills per kernel),
    which are also kept beside the library."""
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{name}.{tag}.o")
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
             os.path.join(CSRC, name), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for name, p in procs:
        out, _ = p.communicate()
        report += [ln.strip() for ln in out.splitlines()
                   if "ptxas" in ln or "spill" in ln]
        if p.returncode != 0:
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{lib_path}.{tag}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    for obj in objs:
        os.remove(obj)
    with open(f"{log_path}.{tag}.tmp", "w") as f:
        f.write("\n".join(report))
    # atomic renames, log first: no process reads a half-written file or
    # finds the library without its log
    os.replace(f"{log_path}.{tag}.tmp", log_path)
    os.replace(tmp, lib_path)
    return report


def load(force: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use (or anew with force=True)."""
    global _lib
    if _lib is not None and not force:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libgnnla_kernels_{_digest()}.so")
    log_path = lib_path + ".ptxas.txt"
    t0 = time.perf_counter()
    if force or not os.path.exists(lib_path):
        report = _compile(nvcc_path(), lib_path, log_path)
        built = True
    else:
        with open(log_path) as f:
            report = f.read().splitlines()
        built = False
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.dia_spmv_f32, lib.dia_spmv_bf16):
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, ci, ci, vp, ci, vp, vp, vp, vp,
                       ctypes.c_float, vp, vp]
    lib.csr_spmv_f32.restype = ci
    lib.csr_spmv_f32.argtypes = [vp, vp, vp, ci, vp, ci, ci, vp, vp, vp]
    lib.csr_spmm_f32.restype = ci
    lib.csr_spmm_f32.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
    lib.stencil_f32.restype = ci
    lib.stencil_f32.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp, vp, vp, vp,
                                ci, ci, ci, ci, ci, ci, vp]
    lib.health_f32.restype = ci
    lib.health_f32.argtypes = [vp, vp, ctypes.c_int64, vp]
    lib.ellw_spmv_f32.restype = ci
    lib.ellw_spmv_f32.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, ci, vp, vp]
    lib.ellw_spmv_trim_f32.restype = ci
    lib.ellw_spmv_trim_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp,
                                       ci, vp, vp]
    lib.gather_axis1_f32.restype = ci
    lib.gather_axis1_f32.argtypes = [vp, ci, vp, vp, vp, vp,
                                     ctypes.c_longlong, vp]
    lib.gather_axis0_f32.restype = ci
    lib.gather_axis0_f32.argtypes = [vp, ci, vp, vp, ctypes.c_longlong, ci,
                                     vp]
    lib.csr_ablate_f32.restype = ci
    lib.csr_ablate_f32.argtypes = [ci, vp, vp, vp, ci, vp, ci, ci, vp, vp,
                                   vp]
    _info.update(path=lib_path, built=built, ptxas=report,
                 seconds=time.perf_counter() - t0)
    _lib = lib
    return lib


def build_info() -> dict:
    """path, built (False = reused), seconds and ptxas lines of the last
    `load()`."""
    return dict(_info)


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
