"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc.

Each source is compiled on first use, one nvcc process per source, all
started together, into a shared library with a plain C interface under
``build/torch_kernels/`` at the root of the checkout, and loaded with ctypes.
A library is rebuilt when any source under csrc/ (a kernel may include
another's source or a shared header) or this file is newer than it. Nothing
here runs at import time: the package imports on a host without nvcc.

Flags: sm_90a (Hopper), -O3, --fmad=false. Without contraction the kernels
round as the plain PyTorch versions do, so kernel and plain version agree to
the last bits up to operation order.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("tp2d_sweep", "a2b_ord4", "ke_section", "sim1", "c_sw",
           "d_sw_fluxes", "d_sw_winds")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs = {}
_lock = threading.Lock()


def nvcc_path():
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _stale(name):
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max([p.stat().st_mtime for p in CSRC.glob("*.cu*")]
                 + [Path(__file__).stat().st_mtime])
    return lib.stat().st_mtime < newest


def build(names=SOURCES, force=False):
    """Compile the named kernels concurrently. Returns {name: seconds} for
    the ones compiled (empty when all were up to date); raises RuntimeError
    with nvcc's output when a compile fails. ptxas's register and spill
    report goes to build/torch_kernels/<name>.log."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    secs, errors = {}, []
    for name, (p, tmp) in procs.items():
        out, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(out)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name):
    """The loaded ctypes library of kernel `name`, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(rc, name):
    """Raise when a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")


def stream_ptr(t):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(t):
    import torch
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.float64:
        return 1
    raise TypeError(f"kernels take float32 or float64, not {t.dtype}")
