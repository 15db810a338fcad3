"""Build and load the port's CUDA kernels.

Every `stabletts_torch/csrc/*.cu` is compiled by its own `nvcc` process (all
started together) into a shared library with a plain C interface, then bound
with `ctypes`. The build runs at first CUDA use, never at import, and writes
to `build/stabletts_torch_kernels/` beside the package (listed in
`.gitignore`). A library newer than every source is reused. Processes that
build at once (the ranks of a data-parallel run on one machine) take turns
on a file lock in that directory, and each writes its own temporary file, so
the second finds the first's libraries and builds nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "stabletts_torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# f32 workspace of the weight-gradient GEMM's row chunks (common.cuh
# launch_wgrad) and of the column sums' (launch_colsum), which reuse it: 16 MB,
# enough for ~1000 FMA CTAs at the flagship widths and for the 240-252 wgmma
# CTAs of each bf16 weight gradient; the column sums' partials take at most
# ~34k floats
WGRAD_WS_FLOATS = 1 << 22

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _stale(src: str, lib: str, headers) -> bool:
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(p) for p in [src, *headers])
    return os.path.getmtime(lib) < newest


def build_all() -> dict:
    """Compile every kernel source (in parallel) and load each library.
    Returns {name: ctypes.CDLL}. Raises with nvcc's output on failure."""
    with _lock:
        if _libs:
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "lock"), "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when the file closes
            _build_locked()
        return _libs


def _build_locked() -> None:
    """build_all's work, under the file lock."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    procs = {}
    for src in sources:
        name = os.path.splitext(os.path.basename(src))[0]
        lib = os.path.join(BUILD_DIR, f"lib{name}.so")
        if _stale(src, lib, headers):
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", f"{lib}.{os.getpid()}.tmp", src]
            procs[name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(f"{lib}.{os.getpid()}.tmp", lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    for src in sources:
        name = os.path.splitext(os.path.basename(src))[0]
        _libs[name] = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))


def load(name: str, fn: str, n_ptr: int, n_int: int, n_float: int = 0, stream: bool = True):
    """The C entry point `fn` of library `name`, with argtypes set: `n_ptr`
    pointers, then `n_int` ints, then `n_float` floats, then the stream
    (unless `stream` is False). It returns an int: the cudaError_t of its
    launches, or the value it reports."""
    f = getattr(build_all()[name], fn)
    if not getattr(f, "_stts_bound", False):
        f.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            + [ctypes.c_float] * n_float + [ctypes.c_void_p] * int(stream)
        )
        f.restype = ctypes.c_int
        f._stts_bound = True
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
