"""ctypes binding to the native host library (native/libgdf_native.so).

≅ the reference's dlopen-based binding layer (python/libgdf_cffi/
__init__.py:14-31 dlopens libgdf.so): the native library is optional —
every consumer has a pure-Python fallback — and is auto-built from
native/ on first import when a toolchain is present.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgdf_native.so")

_lib = None


def _try_build() -> None:
    """Build the library from native/ into a name of this process's own,
    then rename it into place: the rename is atomic, so parallel
    processes (test workers) never load a half-written file."""
    src = os.path.join(_NATIVE_DIR, "csvparse.cpp")
    if not os.path.exists(src):
        return
    tmp = f"libgdf_native.so.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"LIB={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        pass  # no toolchain: every consumer has a pure-Python fallback
    finally:
        if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
            os.remove(os.path.join(_NATIVE_DIR, tmp))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _try_build()
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.gdf_csv_open.restype = ctypes.c_void_p
    lib.gdf_csv_open.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                 ctypes.c_char, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int]
    lib.gdf_csv_nrows.restype = ctypes.c_longlong
    lib.gdf_csv_nrows.argtypes = [ctypes.c_void_p]
    lib.gdf_csv_parse_column.restype = ctypes.c_int
    lib.gdf_csv_parse_column.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p]
    lib.gdf_csv_field.restype = ctypes.c_longlong
    lib.gdf_csv_field.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_longlong]
    lib.gdf_csv_close.restype = None
    lib.gdf_csv_close.argtypes = [ctypes.c_void_p]
    try:
        lib.gdf_csv_column_text.restype = ctypes.c_longlong
        lib.gdf_csv_column_text.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p,
                                            ctypes.c_void_p]
    except AttributeError:  # stale .so without the batched entry point
        lib.gdf_csv_column_text = None
    _lib = lib
    return lib


# dtype codes shared with native/csvparse.cpp
DTYPE_CODES = {np.dtype(np.int8): 1, np.dtype(np.int16): 2,
               np.dtype(np.int32): 3, np.dtype(np.int64): 4,
               np.dtype(np.float32): 5, np.dtype(np.float64): 6}


def csv_scan_available() -> bool:
    return _load() is not None


class NativeCsv:
    """One opened CSV file (mmap + record index held in C++)."""

    def __init__(self, path: str, delimiter: str = ",",
                 lineterminator: str = "\n", skiprows: int = 0,
                 skipfooter: int = 0, skipinitialspace: bool = False):
        lib = _load()
        if lib is None:
            raise ImportError("libgdf_native.so unavailable")
        self._lib = lib
        self._h = lib.gdf_csv_open(path.encode(), delimiter.encode(),
                                   lineterminator.encode(), skiprows,
                                   skipfooter, int(skipinitialspace))
        if not self._h:
            raise OSError(f"cannot open {path}")

    @property
    def nrows(self) -> int:
        return int(self._lib.gdf_csv_nrows(self._h))

    def parse_numeric(self, col: int, dtype):
        """(values, null_mask) for a numeric column."""
        dt = np.dtype(dtype)
        n = self.nrows
        out = np.empty(n, dt)
        valid = np.empty(n, np.uint8)
        rc = self._lib.gdf_csv_parse_column(
            self._h, col, DTYPE_CODES[dt],
            out.ctypes.data_as(ctypes.c_void_p),
            valid.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise ValueError(f"unsupported native dtype {dt}")
        return out, valid == 0

    def field(self, row: int, col: int) -> str:
        """Raw text of one field (str/date columns)."""
        cap = 256
        buf = ctypes.create_string_buffer(cap)
        ln = self._lib.gdf_csv_field(self._h, row, col, buf, cap)
        if ln > cap:
            buf = ctypes.create_string_buffer(ln)
            ln = self._lib.gdf_csv_field(self._h, row, col, buf, ln)
        return buf.raw[:ln].decode("utf-8", errors="replace")

    def column_text(self, col: int):
        """All raw field texts of one column.

        One batched C call (offsets + contiguous bytes buffer) instead
        of one ctypes round-trip per field — the per-field path cost
        str/date columns most of the native scanner's win (each call
        also re-scanned the record from column 0). Falls back to the
        per-field path on a stale .so."""
        fn = getattr(self._lib, "gdf_csv_column_text", None)
        if fn is None:
            return [self.field(i, col) for i in range(self.nrows)]
        n = self.nrows
        offsets = np.empty(n + 1, np.int64)
        total = fn(self._h, col, offsets.ctypes.data_as(ctypes.c_void_p),
                   None)
        buf = np.empty(max(int(total), 1), np.uint8)
        fn(self._h, col, offsets.ctypes.data_as(ctypes.c_void_p),
           buf.ctypes.data_as(ctypes.c_void_p))
        off = offsets.tolist()          # python ints: fast slicing below
        if not (buf & 0x80).any():      # ASCII: byte offsets == chars
            s = buf.tobytes().decode("ascii")
            return [s[off[i]:off[i + 1]] for i in range(n)]
        mv = memoryview(buf)
        return [str(mv[off[i]:off[i + 1]], "utf-8", "replace")
                for i in range(n)]

    def close(self):
        if self._h:
            self._lib.gdf_csv_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def csv_scan_file(path, delimiter, lineterminator, num_cols, skiprows,
                  skipfooter, skipinitialspace):
    """Field matrix via the native scanner (fallback-compatible shape:
    list of rows, each a list of str fields)."""
    f = NativeCsv(path, delimiter, lineterminator, skiprows, skipfooter,
                  skipinitialspace)
    try:
        if f.nrows == 0:
            return []
        cols = [f.column_text(j) for j in range(num_cols)]
        return [list(row) for row in zip(*cols)]
    finally:
        f.close()
