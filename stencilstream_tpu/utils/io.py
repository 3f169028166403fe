"""Host-side grid I/O used by the example applications.

Formats mirror the reference apps so inputs/outputs are interchangeable:

* Conway's ``X``/``.`` character grids on stdin/stdout
  (``examples/conway/conway.cpp:58-88``),
* HotSpot's whitespace-separated text and raw-float32 binary temperature /
  power files (``examples/hotspot/hotspot.cpp:141-202``),
* Jacobi's raw float32 row-major dump (``examples/jacobi/jacobi.cpp:144-154``),
* FDTD/Convection CSV frames (comma fields, newline rows,
  ``examples/fdtd/src/fdtd.cpp:114-166``,
  ``examples/convection/convection.cpp:460-477``).
"""

from __future__ import annotations

import sys
from typing import IO, Iterable, Iterator

import numpy as np

from .. import native as _native


def _use_native() -> bool:
    return _native.available()

__all__ = [
    "read_char_grid",
    "write_char_grid",
    "read_float_grid_text",
    "read_float_grid_binary",
    "write_float_grid_binary",
    "write_indexed_text",
    "write_csv_frame",
]


def _tokens(stream: IO[str]) -> Iterator[str]:
    for line in stream:
        yield from line.split()


def read_char_grid(stream: IO[str], height: int, width: int) -> np.ndarray:
    """Read a ``height*width`` grid of ``X`` (alive) / ``.`` (dead) characters,
    skipping whitespace like ``std::cin >> char``. Dispatches to the native
    parser (:mod:`stencilstream_tpu.native`) when built."""
    if _use_native():
        # Read incrementally — exactly enough characters to cover
        # height*width non-whitespace cells — so the stream is left where the
        # Python fallback (and the reference's ``std::cin >> char``) leaves
        # it: just past the last cell. Each request asks
        # for at most the number of still-missing cells, so the loop can
        # overshoot only on whitespace *between* cells, never past the grid.
        total = height * width
        parts: list[str] = []
        count = 0
        while count < total:
            chunk = stream.read(total - count)
            if not chunk:
                break  # truncated; the native parser raises with coordinates
            parts.append(chunk)
            count += len("".join(chunk.split()))
        return _native.parse_char_grid("".join(parts).encode(), height, width)
    out = np.empty((height, width), dtype=bool)
    chars = (ch for line in stream for ch in line if not ch.isspace())
    for r in range(height):
        for c in range(width):
            try:
                ch = next(chars)
            except StopIteration:
                raise ValueError(
                    f"character grid truncated at cell ({r}, {c}); "
                    f"expected {height}x{width} cells"
                ) from None
            if ch not in "X.":
                raise ValueError(f"unexpected character {ch!r} at cell ({r}, {c})")
            out[r, c] = ch == "X"
    return out


def write_char_grid(stream: IO[str], grid: np.ndarray) -> None:
    if _use_native():
        stream.write(_native.format_char_grid(np.asarray(grid, dtype=bool)).decode())
        return
    for row in np.asarray(grid, dtype=bool):
        stream.write("".join("X" if v else "." for v in row))
        stream.write("\n")


def read_float_grid_text(path: str, height: int, width: int) -> np.ndarray:
    if _use_native():
        with open(path, "rb") as f:
            return _native.parse_floats(f.read(), height * width).reshape(height, width)
    with open(path) as f:
        vals = np.fromiter(_tokens(f), dtype=np.float32, count=height * width)
    return vals.reshape(height, width)


def read_float_grid_binary(path: str, height: int, width: int) -> np.ndarray:
    vals = np.fromfile(path, dtype=np.float32, count=height * width)
    if vals.size != height * width:
        raise ValueError(f"{path}: expected {height * width} float32s, got {vals.size}")
    return vals.reshape(height, width)


def write_float_grid_binary(path: str, grid: np.ndarray) -> None:
    np.asarray(grid, dtype=np.float32).tofile(path)


def write_indexed_text(path: str, grid: np.ndarray) -> None:
    """HotSpot text output: ``<flat index>\\t<value>`` per line
    (``examples/hotspot/hotspot.cpp:156-163``)."""
    flat = np.asarray(grid, dtype=np.float32).ravel()
    if _use_native():
        with open(path, "wb") as f:
            f.write(_native.format_indexed_text(flat))
        return
    with open(path, "w") as f:
        for i, v in enumerate(flat):
            f.write(f"{i}\t{v:g}\n")


def write_csv_frame(path: str, grid: np.ndarray, fmt: str = "%g") -> None:
    if fmt == "%g" and _use_native():
        with open(path, "wb") as f:
            f.write(_native.format_csv(np.asarray(grid)))
        return
    np.savetxt(path, np.asarray(grid), fmt=fmt, delimiter=",")
