"""Build and load the port's CUDA kernels (``aim_tpu_torch/csrc/*.cu``).

``nvcc`` compiles every source to an object, one process a source, all
started together, and links them into one shared library with a plain C
interface, ``aim_tpu_torch/_build/libaimk_<hash>.so``, keyed on a hash of
the sources (headers included) and flags, so an edited source rebuilds
and an unchanged one loads at once.  The library is loaded with
``ctypes``; wrappers pass device pointers and the current stream as
``c_void_p``.

Nothing here runs at import time.  A failed build raises with the
compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
build_seconds = None  # wall time of the last build in this process


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the port's kernels are built on the machine with "
                       "the GPU")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libaimk_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless a library of the same hash exists."""
    global build_seconds
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.path.basename(so)[:-3]}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        if not src.endswith(".cu"):
            continue
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc] + NVCC_FLAGS + ["-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp] + objs
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_seconds = time.perf_counter() - t0
    return so


def load():
    """Build if needed, then load the library and declare its functions."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = declare(ctypes.CDLL(build()))
        return _LIB


def declare(lib):
    """Declare the C interface of a library built from csrc/ (the argument
    and return types ctypes needs to pass 64-bit pointers)."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.aim_wfa2_forward.restype = ci
    lib.aim_wfa2_forward.argtypes = [vp, vp, vp, vp, vp, vp, cl,
                                     ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                     ci, vp]
    # smax Rp hist_smem (K1) or smax R packed (K5), then the int[6] of
    # INFO_KEYS
    for fn in (lib.aim_wfa_info, lib.aim_wfa_long_info):
        fn.restype = ci
        fn.argtypes = [ci] * 3 + [vp]
    # pointers, n, then width packed R C L NRL DS, the costs, the flags
    # check_ovf backtrace planes_smem, and the stream
    lib.aim_nw_forward.restype = ci
    lib.aim_nw_forward.argtypes = [vp] * 6 + [cl] + [ci] * 13 + [vp]
    lib.aim_swg_forward.restype = ci
    lib.aim_swg_forward.argtypes = [vp] * 6 + [cl] + [ci] * 17 + [vp]
    # R L backtrace planes_smem, then the int[6] of INFO_KEYS
    for fn in (lib.aim_nw_info, lib.aim_swg_info):
        fn.restype = ci
        fn.argtypes = [ci] * 4 + [vp]
    # pointers, n, then width R k Rp backtrace hist_smem, and the stream
    lib.aim_genasm_forward.restype = ci
    lib.aim_genasm_forward.argtypes = [vp] * 6 + [cl] + [ci] * 6 + [vp]
    # R k backtrace hist_smem, then the int[6] of INFO_KEYS
    lib.aim_genasm_info.restype = ci
    lib.aim_genasm_info.argtypes = [ci] * 4 + [vp]
    # pointers, n, then width packed smax R, the costs, the flags
    # adaptive backtrace, and the stream
    lib.aim_wfa_long_forward.restype = ci
    lib.aim_wfa_long_forward.argtypes = [vp] * 6 + [cl] + [ci] * 9 + [vp]
    # pointers (pats txts plens tlens meta codes ism rec), n, then width
    # packed weff lpad R planes NRL swg backtrace, the costs gi gd x mat go
    # ge ms, and the stream
    lib.aim_nwswg_long_forward.restype = ci
    lib.aim_nwswg_long_forward.argtypes = [vp] * 8 + [cl] + [ci] * 16 + [vp]
    # planes swg, then the int[6] of INFO_KEYS (K6 and K7)
    for fn in (lib.aim_nwswg_long_info, lib.aim_nwswg_long_walk_info):
        fn.restype = ci
        fn.argtypes = [ci, ci, vp]
    # pointers (codes ism meta plens tlens rec), n, then R planes NRL RB
    # swg, and the stream
    lib.aim_nwswg_long_walk.restype = ci
    lib.aim_nwswg_long_walk.argtypes = [vp] * 6 + [cl] + [ci] * 5 + [vp]
    # probe index, pointers (a, b, out), reps, and the stream
    lib.aim_probe.restype = ci
    lib.aim_probe.argtypes = [ci, vp, vp, vp, ci, vp]
    lib.aim_cuda_error_string.restype = ctypes.c_char_p
    lib.aim_cuda_error_string.argtypes = [ci]
    return lib


def error_string(code: int) -> str:
    return load().aim_cuda_error_string(int(code)).decode()


# What ``aim_<name>_info`` reports of the kernel a config launches: CUDA's
# function attributes, its occupancy calculator at the launch's shared
# memory, and the kernel's path.
INFO_KEYS = ("registers", "local_bytes", "smem_block_bytes", "blocks_per_sm",
             "pairs_per_warp", "hist_windowed")


def kernel_info(name: str, *ints) -> dict:
    """``aim_<name>_info(*ints, out)`` of the loaded library as a dict of
    INFO_KEYS; raises if the call fails."""
    out = (ctypes.c_int * len(INFO_KEYS))()
    rc = getattr(load(), f"aim_{name}_info")(*ints, out)
    if rc != 0:
        raise RuntimeError(f"{name} kernel info failed: {error_string(rc)} "
                           f"(cudaError {rc})")
    return dict(zip(INFO_KEYS, out))
