"""ctypes loader for the native runtime library (``native/``: the
permutohedral dense CRF, connected components, RLE), the counterpart of
``irn_tpu.ops.native``.

The JAX package loads the ``native/libirn_native.so`` kept in the
repository, built with ``-march=native`` on the machine that built it; on
another host's CPU it may not load, or may stop on an illegal instruction.
The port therefore builds ``native/*.cpp`` itself with the same flags at
first use, never at import, into ``irn_tpu_torch/_kernels/`` (git-ignored).
The file name carries a digest of the sources, the flags and the host CPU
(``-march=native`` code is only valid on the CPU it was built for), so an
edited source or another host never loads a stale build.

Where the compiler has no OpenMP runtime (``-fopenmp`` cannot link), the
library builds without it: the lattice then runs serial in each call
(``set_num_threads`` returns 1), the bit-exact single-thread path, and
cam_to_ir_label's thread pool still spreads the images over the cores.

Without a C++ compiler (``CXX``, else ``g++`` or ``c++`` on the path) the
library is absent and every consumer takes its NumPy fallback, as the JAX
package does without ``native/libirn_native.so``; a compiler that fails
raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
NATIVE_SRC = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_kernels")
# native/Makefile's flags; -fopenmp joins them where the compiler has
# OpenMP (the sources build serial without it)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wextra")
OPENMP_PROBE = "#include <omp.h>\nint main() { return omp_get_max_threads(); }\n"

_lock = threading.Lock()
_loaded = False
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def _sources():
    return sorted(glob.glob(os.path.join(NATIVE_SRC, "*.cpp")))


def _host_cpu() -> str:
    """What ``-march=native`` resolves from: the CPU model and its feature
    flags (``/proc/cpuinfo``), else the machine name."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))) or platform.machine()
    except OSError:
        return platform.machine()


def _digest(cxx: str, flags) -> str:
    h = hashlib.sha256()
    for path in _sources() + sorted(glob.glob(os.path.join(NATIVE_SRC,
                                                            "*.h"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join((cxx, *flags)).encode())
    h.update(_host_cpu().encode())
    return h.hexdigest()[:16]


def has_openmp(cxx: str) -> bool:
    """Whether ``cxx -fopenmp`` compiles and links a program that calls the
    OpenMP runtime (a compiler may ship without libgomp)."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write(OPENMP_PROBE)
        proc = subprocess.run(
            [cxx, "-fopenmp", src, "-o", os.path.join(tmp, "probe")],
            capture_output=True, text=True)
    return proc.returncode == 0


def build(cxx: str) -> str:
    """Compile ``native/*.cpp`` into one shared library (cached by digest);
    returns its path. Raises with the compiler's output if it fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    openmp = has_openmp(cxx)
    flags = CXX_FLAGS + (("-fopenmp",) if openmp else ())
    out = os.path.join(BUILD_DIR, f"libirn_native_{_digest(cxx, flags)}.so")
    BUILD_INFO.update(openmp=openmp)
    if os.path.exists(out):
        BUILD_INFO.update(path=out, seconds=0.0, cached=True)
        return out
    t0 = time.perf_counter()
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *flags, "-shared", "-I", NATIVE_SRC, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds write the same file
    BUILD_INFO.update(path=out, seconds=time.perf_counter() - t0,
                      cached=False)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first call; None without a compiler."""
    global _loaded, _lib
    with _lock:
        if not _loaded:
            cxx = (os.environ.get("CXX") or shutil.which("g++")
                   or shutil.which("c++"))
            if cxx:
                lib = ctypes.CDLL(build(cxx))
                _declare(lib)
                _lib = lib
            _loaded = True
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.irn_dense_crf_label.argtypes = [
        u8p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        i32p,
    ]
    lib.irn_dense_crf_label.restype = None

    lib.irn_dense_crf_label2.argtypes = [
        u8p, i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        i32p, i32p,
    ]
    lib.irn_dense_crf_label2.restype = None

    lib.irn_permutohedral_filter.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p
    ]
    lib.irn_permutohedral_filter.restype = None

    lib.irn_label_components.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i32p]
    lib.irn_label_components.restype = ctypes.c_int

    lib.irn_rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p]
    lib.irn_rle_encode.restype = ctypes.c_int

    lib.irn_set_num_threads.argtypes = [ctypes.c_int]
    lib.irn_set_num_threads.restype = ctypes.c_int


def set_num_threads(n: int) -> int:
    """OpenMP threads for the native permutohedral filter (1 = serial).
    Returns the effective count, or 1 when the library is absent. Image
    fan-out (cam_to_ir_label's thread pool) and filter threads multiply:
    divide the cores."""
    lib = load()
    if lib is None:
        return 1
    return int(lib.irn_set_num_threads(int(n)))
