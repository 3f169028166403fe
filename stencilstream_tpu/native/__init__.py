"""Native host-runtime library: build-on-first-use + ctypes bindings.

The reference's runtime is C++ throughout; this package is this
framework's native layer for the host data path (file-format parse/format kernels,
:mod:`io_kernels.cpp <.>`). The shared library is compiled once with the
system toolchain and cached next to the sources; every entry point has a
pure-Python fallback in :mod:`stencilstream_tpu.utils.io`, so the framework
works (slower) even without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "available",
    "parse_char_grid",
    "format_char_grid",
    "parse_floats",
    "format_indexed_text",
    "format_csv",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "io_kernels.cpp")
_LIB_PATH = os.path.join(_HERE, "_io_kernels.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> str | None:
    try:
        if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
            return _LIB_PATH
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB_PATH],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH
    except Exception:
        return None


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        i64, c_char_p, u8_p, f32_p, f64_p = (
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
        )
        lib.ss_parse_char_grid.restype = i64
        lib.ss_parse_char_grid.argtypes = [c_char_p, i64, i64, i64, u8_p]
        lib.ss_format_char_grid.restype = i64
        lib.ss_format_char_grid.argtypes = [u8_p, i64, i64, c_char_p]
        lib.ss_parse_floats.restype = i64
        lib.ss_parse_floats.argtypes = [c_char_p, i64, i64, f32_p]
        lib.ss_format_indexed_text.restype = i64
        lib.ss_format_indexed_text.argtypes = [f32_p, i64, c_char_p]
        lib.ss_format_csv.restype = i64
        lib.ss_format_csv.argtypes = [f32_p, i64, i64, c_char_p]
        lib.ss_format_csv_f64.restype = i64
        lib.ss_format_csv_f64.argtypes = [f64_p, i64, i64, c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_char_grid(text: bytes, height: int, width: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.empty(height * width, dtype=np.uint8)
    rc = lib.ss_parse_char_grid(
        text, len(text), height, width, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    if rc < 0:
        cells = height * width
        code = -rc - 1
        if code >= cells:
            cell = code - cells
            raise ValueError(
                f"unexpected character at cell ({cell // width}, {cell % width}); "
                f"expected 'X' or '.'"
            )
        raise ValueError(
            f"character grid truncated at cell ({code // width}, {code % width}); "
            f"expected {height}x{width} cells"
        )
    return out.reshape(height, width).astype(bool)


def format_char_grid(grid: np.ndarray) -> bytes:
    lib = _load()
    assert lib is not None
    g = np.ascontiguousarray(grid, dtype=np.uint8)
    h, w = g.shape
    buf = ctypes.create_string_buffer(h * (w + 1))
    n = lib.ss_format_char_grid(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, buf
    )
    return buf.raw[:n]


def parse_floats(text: bytes, count: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.empty(count, dtype=np.float32)
    n = lib.ss_parse_floats(
        text + b"\0",
        len(text),
        count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n != count:
        raise ValueError(f"expected {count} floats, parsed {n}")
    return out


def format_indexed_text(vals: np.ndarray) -> bytes:
    lib = _load()
    assert lib is not None
    v = np.ascontiguousarray(vals, dtype=np.float32).ravel()
    buf = ctypes.create_string_buffer(v.size * 32)
    n = lib.ss_format_indexed_text(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.size, buf
    )
    return buf.raw[:n]


def format_csv(grid: np.ndarray) -> bytes:
    lib = _load()
    assert lib is not None
    g = np.ascontiguousarray(grid)
    if g.dtype == np.float64:
        buf = ctypes.create_string_buffer(g.size * 24 + g.shape[0])
        n = lib.ss_format_csv_f64(
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), g.shape[0], g.shape[1], buf
        )
    else:
        g = np.ascontiguousarray(g, dtype=np.float32)
        buf = ctypes.create_string_buffer(g.size * 16 + g.shape[0])
        n = lib.ss_format_csv(
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), g.shape[0], g.shape[1], buf
        )
    return buf.raw[:n]
