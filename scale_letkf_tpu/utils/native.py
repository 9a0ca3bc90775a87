"""ctypes loader for the native C++ codec (native/libfortseq.so).

The shared library is a build product, not part of the source tree: it is
built from native/fortseq.cpp on first use, and rebuilt whenever the
source is newer. Callers must handle `load() is None` (no toolchain) and
fall back to pure-NumPy paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB = None
_TRIED = False


def _stale(so: Path, src: Path) -> bool:
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def build(native_dir: Path = _NATIVE_DIR) -> Path:
    """Build libfortseq.so in native_dir if it is missing or older than
    fortseq.cpp, and return its path. A lock file serializes concurrent
    builders (parallel test workers); subprocess errors propagate."""
    so = native_dir / "libfortseq.so"
    src = native_dir / "fortseq.cpp"
    if not _stale(so, src):
        return so
    with open(native_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(so, src):
            subprocess.run(["make", "-B", "-C", str(native_dir),
                            "libfortseq.so"], check=True,
                           capture_output=True, timeout=120)
    return so


def load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = build()
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    lib.fortseq_read_f32.restype = ctypes.c_long
    lib.fortseq_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.fortseq_read_scalars_f32.restype = ctypes.c_int
    lib.fortseq_read_scalars_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.fortseq_write_f32.restype = ctypes.c_int
    lib.fortseq_write_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_int]
    lib.fortseq_count_f32.restype = ctypes.c_long
    lib.fortseq_count_f32.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.c_int]
    lib.bucket_sort.restype = ctypes.c_long
    lib.bucket_sort.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.bucket_max_count.restype = ctypes.c_int
    lib.bucket_max_count.argtypes = lib.bucket_sort.argtypes[:-2]
    _LIB = lib
    return _LIB
