"""ctypes bindings for the port's native host library (C++ in this folder).

`audio.cpp`, `flac.cpp` and `mas.cpp` are the port's own copies of the JAX
package's `native/` sources. At first use they are compiled together by g++
(the same command the JAX package uses) into
`build/stabletts_torch_native/libstabletts_native.so` beside the package
(listed in `.gitignore`); a library newer than every source is reused. Where
no compiler is found every binding returns None and its callers take their
Python fallback. Bound here: stabletts_load_wav / stabletts_wav_length /
stabletts_load_segment, WAV and FLAC decode with windowed-sinc resampling, for
the reference voice of a request and the vocoder dataset's segments. (The
library also holds `mas.cpp`'s host MAS, which no path of the port calls: the
port's MAS runs on the device.)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)), "build", "stabletts_torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libstabletts_native.so")
SOURCES = ("mas.cpp", "audio.cpp", "flac.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    sources = [os.path.join(_SRC_DIR, f) for f in SOURCES]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"  # parallel test workers may build at once
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, *sources, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):  # no g++, or it failed
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None if it cannot be built."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        newest = max(os.path.getmtime(os.path.join(_SRC_DIR, f)) for f in SOURCES)
        stale = not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < newest
        if stale and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.stabletts_load_wav.restype = ctypes.c_int64
        lib.stabletts_load_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ]
        lib.stabletts_wav_length.restype = ctypes.c_int64
        lib.stabletts_wav_length.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.stabletts_load_segment.restype = ctypes.c_int
        lib.stabletts_load_segment.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def load_wav_native(path: str, target_sr: int):
    """(float32 waveform at target_sr, source rate), or None if the library
    is unavailable or the file does not decode.

    Two phases: stabletts_wav_length gives the exact length after resampling
    from the headers alone (WAV chunk sizes, FLAC STREAMINFO), so the buffer
    fits the file; stabletts_load_wav returns -needed when the buffer is too
    small, and the call then retries once at that size instead of truncating."""
    lib = get_lib()
    if lib is None:
        return None
    n_expect = int(lib.stabletts_wav_length(path.encode(), target_sr))
    if n_expect <= 0:
        return None
    src_sr = ctypes.c_int(0)
    for _ in range(2):
        out = np.empty(n_expect + 8, dtype=np.float32)
        n = lib.stabletts_load_wav(
            path.encode(), target_sr,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.shape[0], ctypes.byref(src_sr),
        )
        if n > 0:
            return out[:n].copy(), int(src_sr.value)
        if n == 0:
            return None
        n_expect = -n
    return None


def load_segment_native(
    path: str, target_sr: int, segment_len: int, start_frac: float
) -> Optional[np.ndarray]:
    """[segment_len] float32 crop of the file resampled to target_sr, starting
    at start_frac of the free range and zero-padded if short; None if the
    library is unavailable or the file does not decode."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(segment_len, dtype=np.float32)
    ok = lib.stabletts_load_segment(
        path.encode(), target_sr, segment_len, float(start_frac),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if ok else None
