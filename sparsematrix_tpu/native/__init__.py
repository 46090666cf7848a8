"""Native (C++) host codec, loaded via ctypes.

Builds ``libsmtpu_codec.so`` from ``codec.cc`` on first use (g++ -O3) and
caches it next to the source.  All entry points have numpy fallbacks in
``formats/codebook.py``; ``get_lib()`` returns None when no compiler is
available so the pure-Python paths keep working.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.cc")
_SO = os.path.join(_HERE, "libsmtpu_codec.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Return the loaded ctypes library, building if needed; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        c_long = ctypes.c_long
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.smtpu_encode_stream.restype = c_long
        lib.smtpu_encode_stream.argtypes = [
            c_i32p, c_long, c_long, ctypes.c_int32,
            c_u8p, c_u8p, c_long, c_i32p, c_i32p, c_i32p,
        ]
        lib.smtpu_decode_stream.restype = c_long
        lib.smtpu_decode_stream.argtypes = [
            c_u8p, c_u8p, c_long, c_f32p, ctypes.c_int32,
            c_i32p, c_i32p, ctypes.c_int32, c_f32p, c_long, c_long,
        ]
        lib.smtpu_decode_stream_coo.restype = c_long
        lib.smtpu_decode_stream_coo.argtypes = [
            c_u8p, c_u8p, c_long, ctypes.c_int32,
            c_i32p, c_i32p, ctypes.c_int32,
            c_i32p, c_i32p, c_i32p, c_long,
        ]
        lib.smtpu_ilu0.restype = c_long
        lib.smtpu_ilu0.argtypes = [
            c_i64p, c_i32p, ctypes.POINTER(ctypes.c_double), c_long,
        ]
        lib.smtpu_ic0.restype = c_long
        lib.smtpu_ic0.argtypes = [
            c_i64p, c_i32p, ctypes.POINTER(ctypes.c_double), c_long,
        ]
        lib.smtpu_index_matrix_to_csr.restype = c_long
        lib.smtpu_index_matrix_to_csr.argtypes = [
            c_i32p, c_long, c_long, ctypes.c_int32,
            c_i64p, c_i32p, c_i32p, c_long,
        ]
        _lib = lib
        return _lib
