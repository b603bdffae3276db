"""ctypes binding of the native IO runtime (native/rfsio.cpp): the port's own
copy of monorfs_tpu.native, host IO and not a kernel.

At first use librfsio.so is built from the repository's native/rfsio.cpp
with g++ into build/native/ (named by a hash of the source and flags) and
loaded. Every entry point returns None when the library cannot be built or
loaded (no compiler, no zlib headers), and its callers then take their
pure-Python fallback (frontend/dataset.py::_load_png_py)."""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "rfsio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]  # no -march=native: a build copied to another host still loads


def _build():
    """Path of the built library, or None when it cannot be built."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not SOURCE.exists():
        return None
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"librfsio_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".librfsio_{digest}.{os.getpid()}.so"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)  # concurrent builders each finish whole
    return lib


@functools.cache
def _load():
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.png_info.restype = ctypes.c_int
    lib.png_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.png_decode.restype = ctypes.c_int
    lib.png_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint16)]
    lib.parse_doubles.restype = ctypes.c_size_t
    lib.parse_doubles.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
    ]
    return lib


def available():
    return _load() is not None


def decode_png(data: bytes):
    """Decode a PNG byte string to a NumPy array, or None without the
    native library."""
    lib = _load()
    if lib is None:
        return None
    w, h, c, b = (ctypes.c_uint32() for _ in range(4))
    rc = lib.png_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), ctypes.byref(b))
    if rc != 0:
        raise ValueError(f"png_info failed: {rc}")
    out = np.empty((h.value, w.value * c.value), np.uint16)
    rc = lib.png_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"png_decode failed: {rc}")
    arr = out.reshape(h.value, w.value, c.value).squeeze()
    if b.value == 8:
        return arr.astype(np.uint8)
    return arr


def parse_doubles(text: str, max_out=1 << 20):
    """Whitespace-separated doubles, or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    out = np.empty(max_out, np.float64)
    n = lib.parse_doubles(raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out)
    return out[:n].copy()
