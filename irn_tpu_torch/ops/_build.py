"""Build and load the hand-written CUDA kernels (``irn_tpu_torch/csrc``).

The kernels expose a plain C interface, so they build with ``nvcc`` alone
(no PyTorch headers: seconds, not minutes): one ``nvcc -c`` per source, all
started together, then one link into a shared library that ``ctypes``
loads. The library is built at first use, never at import, into
``irn_tpu_torch/_kernels/`` (git-ignored); its file name carries a hash of
the sources and flags, so an edited source never loads a stale build.

Every kernel wrapper counts its kernel launches in :data:`LAUNCHES`: each C
entry point reports how many kernels it launched (a chain through K0, K3
or K7 is 1 launch, whatever its length; a batch of B images through K8 is
1, or 1 per image group when it does not fit one wave; one K2, K5 or K6
call is its split pass and its product, 2, in either operand mode; one K10 operator build 1; one
K11 advection 1 (one cooperative launch); one K12a labeling or K12b call
1, and a K12b call that labels first 1 under each of the two; one K15 decode 1 (one cooperative
launch), or 1 for the upsample alone; one
K14 landmark-kernel build 2, its table pass and its rows, whatever its row
range, or 1 for the table pass alone; K17's blur, start, quantize and
combine 1 each; one K16 forward 2, its block sums and their total, one
backward 1), and :func:`launch`
adds that number under a lock (the stages call kernels from a thread
pool, and the make stages from one worker thread per device and stream),
so a run can show that its main path really went through the kernels.

Several threads may launch at once: each launch goes to the current
stream of its thread on the device it names (a worker of
``pipeline.common.DeviceSpreader`` makes its own stream current), and a
kernel's per-stream scratch (:func:`stream_scratch`) is made under the
lock. The cooperative launches (K3, K7, K8, K11, K12, K15) size their
grids from the card's occupancy as if they had it alone, and CUDA makes a
cooperative grid co-resident, so a second stream's kernels may delay it
but cannot leave part of it waiting at a grid barrier; K0's clusters
synchronize within a cluster only, which the hardware schedules whole.
K13's and K16's tables sit in ``__constant__`` memory, one copy per
process, so train_irn launches them from one thread per process.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

KERNELS = ("diag_chain", "pack_banded", "square_banded", "packed_chain",
           "apply_banded", "square_dense", "square_fused_first",
           "banded_chain", "packed_chain_batched", "conv3x3", "advect",
           "ccl_label", "ccl_tables", "path_max_fwd", "path_max_bwd",
           "diag_operator", "decode", "crf_landmark", "crf_mean_field",
           "irn_loss_fwd", "irn_loss_bwd")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))) + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
        f"{CSRC} at first use"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``csrc/*.cu`` into one shared library (cached by content);
    returns its path. Raises with nvcc's output if the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _digest()
    out = os.path.join(BUILD_DIR, f"libirn_tpu_torch_{digest}.so")
    if os.path.exists(out):
        BUILD_INFO.update(path=out, seconds=0.0, cached=True, logs={})
        return out
    nvcc = _nvcc()
    objdir = os.path.join(BUILD_DIR, f"obj_{digest}_{os.getpid()}")
    os.makedirs(objdir, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for cu in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(objdir, os.path.basename(cu)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, cu]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = {}
    for cmd, obj, proc in jobs:
        text, _ = proc.communicate()
        logs[os.path.basename(obj)[:-2]] = text
        if proc.returncode != 0:
            for _, _, other in jobs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    BUILD_INFO.update(
        path=out, seconds=time.perf_counter() - t0, cached=False,
        logs=dict(logs, link=proc.stdout + proc.stderr),
    )
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    n = ctypes.POINTER(ctypes.c_int)  # kernels launched (out)
    lib.irn_diag_chain.argtypes = [
        p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, n,
    ]
    lib.irn_pack_banded.argtypes = [p, p, i, i, i, p, n]
    lib.irn_square_banded.argtypes = [p, p, p, i, i, i, i, i, p, n]
    lib.irn_square_banded_split.argtypes = [p, p, i, i, i, i, p, n]
    lib.irn_packed_chain.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p, n,
    ]
    lib.irn_packed_chain_occupancy.argtypes = [i, i, n, n]
    lib.irn_apply_banded.argtypes = [p, p, p, i, i, i, i, i, p, n]
    lib.irn_diag_chain_clusters.argtypes = [p, i, i, i, i, i, i, i, i, n]
    lib.irn_square_dense.argtypes = [p, p, p, i, i, p, n]
    lib.irn_square_dense_split.argtypes = [p, p, i, i, p, n]
    lib.irn_square_fused_first.argtypes = [p, p, p, p, i, i, i, p, n]
    lib.irn_square_fused_first_split.argtypes = [p, p, p, i, i, i, p, n]
    lib.irn_banded_chain.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, p, n,
    ]
    lib.irn_packed_chain_batched.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, p,
        n,
    ]
    lib.irn_conv3x3.argtypes = [p, p, p, i, i, i, i, i, p, n]
    lib.irn_advect.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float,
                               p, n]
    lib.irn_advect_scratch_words.argtypes = []
    lib.irn_advect_staged_bytes.argtypes = [i, i]
    lib.irn_ccl_label.argtypes = [p, i, p, p, i, i, i, i, p, n]
    lib.irn_ccl_scratch_words.argtypes = [i, i, i]
    lib.irn_cluster_masks.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, n]
    lib.irn_component_tables.argtypes = [
        p, p, i, p, p, p, p, p, p, p, i, i, i, p, n,
    ]
    lib.irn_path_max_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, n]
    lib.irn_path_max_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p,
                                     n]
    lib.irn_diag_operator.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, i,
                                      i, i, p, n]
    lib.irn_upsample_scores.argtypes = [p, p, i, i, i, i, i, i, i, p, n]
    lib.irn_decode.argtypes = [
        p, p, p, p, i, p, p, i, i, i, i, i, i, i, ctypes.c_float, p, n,
    ]
    f = ctypes.c_float
    lib.irn_crf_landmark.argtypes = [
        p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, f, f, p, n,
    ]
    lib.irn_crf_landmark_table.argtypes = [
        p, p, i, i, i, i, i, i, i, i, f, f, p, n,
    ]
    lib.irn_crf_blur.argtypes = [p, p, i, i, i, p, p, n]
    lib.irn_crf_start.argtypes = [p, p, p, i, i, i, i, f, f, p, n]
    lib.irn_crf_quantize.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                     p, n]
    lib.irn_crf_mean_field.argtypes = [
        p, p, p, p, p, i, p, p, p, p, i, i, i, i, i, i, f, f, f, f, p, n,
    ]
    lib.irn_loss_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                 p, n]
    lib.irn_loss_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                 p, n]
    for k in (*(k for k in KERNELS
                if k not in ("ccl_tables", "irn_loss_fwd", "irn_loss_bwd")),
              "loss_fwd", "loss_bwd", "diag_chain_clusters",
              "square_dense_split", "square_fused_first_split",
              "square_banded_split",
              "packed_chain_occupancy", "cluster_masks", "component_tables",
              "ccl_scratch_words",
              "upsample_scores", "crf_landmark_table", "crf_blur",
              "advect_staged_bytes", "advect_scratch_words",
              "crf_start", "crf_quantize"):
        getattr(lib, f"irn_{k}").restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> None:
    """A kernel takes contiguous CUDA tensors of ``dtype`` (float32 unless
    the kernel says otherwise) on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


def _raw_stream(index: int) -> int:
    """The current stream of device ``index`` as a cudaStream_t integer,
    without building a ``torch.cuda.Stream`` (several microseconds a call
    on the card's host)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, device: torch.device, *args,
           entry: Optional[str] = None, also: Tuple[str, ...] = ()) -> None:
    """Call the C entry point ``irn_<entry>`` (default ``irn_<name>``) with
    ``args``, then the current stream of ``device`` and the launch-count
    out-argument; raise on a non-zero cudaError, else add the kernels it
    launched to ``LAUNCHES[name]``, and to each of ``also``: the kernels
    whose phases the same launches ran (K12a inside a K12b launch). The
    device is made current around the call only when it is not already."""
    fn = getattr(load(), f"irn_{entry or name}")
    launched = ctypes.c_int(0)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index == torch.cuda.current_device():
        status = fn(*args, _raw_stream(index), ctypes.byref(launched))
    else:
        with torch.cuda.device(index):
            status = fn(*args, _raw_stream(index), ctypes.byref(launched))
    if status != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError {status}"
        )
    with _count_lock:
        for k in (name, *also):
            LAUNCHES[k] += launched.value


_scratch: Dict[Tuple[str, int, int], torch.Tensor] = {}


def stream_scratch(name: str, device: torch.device,
                   words: int) -> torch.Tensor:
    """``words`` int32 of zeros for kernel ``name`` on ``device``'s current
    stream, allocated at the first call and then reused: a kernel that
    leaves its scratch zeroed (K15's barrier counters) needs no memset
    before its next launch on the same stream."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (name, index, _raw_stream(index))
    with _count_lock:  # several workers' threads make their scratch
        if key not in _scratch:
            _scratch[key] = torch.zeros((words,), dtype=torch.int32,
                                        device=device)
        return _scratch[key]


def is_plain(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the CPU (the kernel's plain twin runs);
    False on CUDA (the kernel runs). Any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain twin for device {t.device}")


def cuobjdump_sass(path: str) -> str:
    """``cuobjdump -sass`` of a built library (the toolkit's cuobjdump, or
    Triton's copy of it)."""
    cands = [os.path.join(os.environ.get(v, ""), "bin", "cuobjdump")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("cuobjdump") or "", "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    exe = next((c for c in cands
                if c and os.path.isfile(c) and os.access(c, os.X_OK)), None)
    if exe is None:
        raise RuntimeError("cuobjdump not found (toolkit or triton)")
    return subprocess.run([exe, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_functions(sass: str) -> Dict[str, List[str]]:
    """The SASS listing's lines per ``Function :`` (mangled name)."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out
