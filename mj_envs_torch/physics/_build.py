"""Build and load the port's CUDA kernels (`mj_envs_torch/csrc/*.cu`).

The sources have a plain C interface and include none of PyTorch's
headers: each is compiled by `nvcc` for `sm_90a` into an object, all of
them at once, and the objects are linked into one shared library that
`ctypes` loads.  The build lands in `mj_envs_torch/_build/<hash>/`
(listed in `.gitignore`), keyed by a hash of the sources and flags, so a
fresh checkout builds at first use and later processes reuse it.  A
failed build or load raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_ROOT = os.path.join(PKG, "_build")
SOURCES = ("chol.cu", "linesearch.cu", "noslip.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = None   # wall time of the build that this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH + FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(out_dir: str) -> None:
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = os.path.join(out_dir, name + ".o")
        cmd = [nvcc] + ARCH + FLAGS + ["-c", os.path.join(CSRC, name),
                                       "-o", obj]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(" ".join(cmd) + "\n" + out.decode(errors="replace"))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    objs = [os.path.join(out_dir, n + ".o") for n in SOURCES]
    cmd = [nvcc] + ARCH + ["-shared", "-o",
                           os.path.join(out_dir, "libmjkernels.so")] + objs
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + " ".join(cmd) + "\n"
                           + res.stdout.decode(errors="replace"))


def library_path() -> str:
    """Path of the built library, building it first if needed."""
    global build_seconds
    final = os.path.join(BUILD_ROOT, _digest())
    lib = os.path.join(final, "libmjkernels.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    # Build in a private directory and move it into place whole, so a
    # concurrent process never loads a half-written library.
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT)
    _compile(tmp)
    if os.path.exists(lib):       # another process finished first
        shutil.rmtree(tmp)
    else:
        os.rename(tmp, final)
    build_seconds = time.perf_counter() - t0
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "chol_factor": [P, P, I, I, P],
        "chol_solve_fac": [P, P, P, I, I, I, P],
        "chol_factor_solve": [P, P, P, I, I, P],
        "linesearch_cost": [P] * 9 + [I, I, I, I, P],
        "noslip_sweep": [P] * 9 + [I, I, I, F, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(library_path()))
    return _lib
