"""ctypes binding for the native asynchronous I/O engine
(native/fvio.cpp), PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/native_io.py. The C++ writer
thread streams restart arrays to disk while the caller goes on (the role of
FV3's FMS I/O stack under tools/fv_io.F90 and tools/fv_restart.F90). The
library is compiled from the unchanged native/fvio.cpp with g++ on first
use into build/torch_native/ at the root of the checkout, and loaded once.
The reader is plain numpy and checks each record's CRC-32 (the standard
polynomial of the writer, as zlib computes it), so reading needs no
library.

File format ("FVIO1"): see the header comment of native/fvio.cpp.
"""

import ctypes
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

_DTYPES = {np.dtype("float32"): 0, np.dtype("float64"): 1,
           np.dtype("int32"): 2, np.dtype("int64"): 3,
           np.dtype("uint8"): 4}
_RTYPES = {v: k for k, v in _DTYPES.items()}

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "fvio.cpp"
BUILD_DIR = ROOT / "build" / "torch_native"

_lib = None
_lib_error = None        # why the library could not be built or loaded
_lib_lock = threading.Lock()


def _compile(so):
    """g++ the source into `so` through a private temporary name, so that
    processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        "-pthread", str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def load_library():
    """Compile (once) and dlopen the fvio shared library; None when the
    source is missing or g++ cannot build it (_lib_error says why)."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not SOURCE.exists():
            _lib_error = f"{SOURCE} is missing"
            return None
        so = BUILD_DIR / "libfvio.so"
        if (not so.exists()
                or so.stat().st_mtime < SOURCE.stat().st_mtime):
            try:
                _compile(so)
            except subprocess.CalledProcessError as e:
                _lib_error = (f"g++ failed on {SOURCE}:\n"
                              + e.stderr.decode(errors="replace"))
                return None
            except OSError as e:
                _lib_error = f"g++ could not run: {e}"
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _lib_error = f"could not load {so}: {e}"
            return None
        lib.fvio_open.restype = ctypes.c_void_p
        lib.fvio_open.argtypes = [ctypes.c_char_p]
        lib.fvio_write.restype = ctypes.c_int
        lib.fvio_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p,
            ctypes.c_uint64]
        lib.fvio_pending.restype = ctypes.c_int
        lib.fvio_pending.argtypes = [ctypes.c_void_p]
        lib.fvio_close.restype = ctypes.c_int
        lib.fvio_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        _lib_error = None
        return _lib


class AsyncWriter:
    """Hand arrays to the C++ writer thread; write() returns as soon as
    the array is copied, close() waits for the thread to finish the
    file."""

    def __init__(self, path):
        lib = load_library()
        if lib is None:
            raise RuntimeError("fvio native library unavailable: "
                               f"{_lib_error}")
        self._lib = lib
        self._h = lib.fvio_open(str(path).encode())
        if not self._h:
            raise OSError(f"fvio_open failed: {path}")

    def write(self, name, array):
        a = np.ascontiguousarray(array)
        code = _DTYPES.get(a.dtype)
        if code is None:
            a = a.astype(np.float64)
            code = _DTYPES[a.dtype]
        dims = (ctypes.c_uint64 * a.ndim)(*a.shape)
        rc = self._lib.fvio_write(
            self._h, name.encode(), code, a.ndim, dims,
            a.ctypes.data_as(ctypes.c_void_p), a.nbytes)
        if rc != 0:
            raise OSError("fvio_write failed")

    def pending(self):
        return self._lib.fvio_pending(self._h)

    def close(self):
        if self._h:
            self._lib.fvio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_fvio(path, arrays):
    """Write a dict of arrays and close (blocking)."""
    with AsyncWriter(path) as w:
        for k, v in arrays.items():
            w.write(k, np.asarray(v))


def read_fvio(path, verify=True):
    """Read an FVIO container into {name: ndarray}, checking each record's
    CRC-32 when verify."""
    out = {}
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic[:5] != b"FVIO\x01":
            raise ValueError(f"not an FVIO file: {path}")
        while True:
            raw = f.read(4)
            if len(raw) < 4:
                raise ValueError("truncated FVIO file")
            (nl,) = struct.unpack("<I", raw)
            if nl == 0:
                break
            name = f.read(nl).decode()
            dtype_c, ndim = struct.unpack("<BB", f.read(2))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            (nb,) = struct.unpack("<Q", f.read(8))
            payload = f.read(nb)
            (crc,) = struct.unpack("<I", f.read(4))
            if verify and zlib.crc32(payload) != crc:
                raise ValueError(f"CRC mismatch for '{name}'")
            out[name] = np.frombuffer(
                payload, dtype=_RTYPES[dtype_c]).reshape(dims)
    return out


def native_available():
    return load_library() is not None
