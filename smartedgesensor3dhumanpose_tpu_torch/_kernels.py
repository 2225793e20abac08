"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The kernels have a plain C interface, so they compile with `nvcc` alone
(seconds, no PyTorch headers): one `nvcc -c` per source, all started
together, then one link into a shared library that is loaded with ctypes.
The build happens at first use, from the sources of this checkout only,
into `_build/` next to this file; the library's name carries a hash of the
sources and flags, so an edited source is never served stale.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("jv_assign.cu", "association_fold.cu", "tracker_scan.cu", "graph_loop.cu")
HEADERS = ("jv.cuh", "bulk_copy.cuh")
# --fmad=false: every float operation rounds on its own, as in the plain
# PyTorch versions the kernels are held to bit for bit.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
)

_lib = None
# Held while the library is built and loaded: callers in several threads
# may reach their first kernel at once.
_LOAD_LOCK = threading.Lock()
# Held while a wrapper adds one to its module's KERNEL_LAUNCHES.
LAUNCH_LOCK = threading.Lock()
build_seconds = None  # wall time of the build this process ran, if any
build_log = None  # nvcc's output of a verbose build this process ran, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source state has no library yet; return
    the library path."""
    global build_seconds, build_log
    out = BUILD_DIR / f"libses3d_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = []
    for src, proc in zip(SOURCES, procs):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{stdout}\n{stderr}")
        logs.append(f"{src}:\n{stdout}{stderr}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    if verbose:
        build_log = "\n".join(logs)
        print(build_log)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ses3d_jv_assign.argtypes = [p, p, p, i, i, i, i, i, p]
            lib.ses3d_jv_assign.restype = i
            lib.ses3d_jv_assign_smem_bytes.argtypes = [i, i, i]
            lib.ses3d_jv_assign_smem_bytes.restype = i
            lib.ses3d_association_fold.argtypes = [
                p, p, p, p, p, i, i, i, i, i, i, f, f, p
            ]
            lib.ses3d_association_fold.restype = i
            lib.ses3d_association_fold_smem_bytes.argtypes = [i, i, i, i]
            lib.ses3d_association_fold_smem_bytes.restype = i
            lib.ses3d_tracker_scan.argtypes = [p] * 16 + [i] * 8 + [f, f, i, f, f, p]
            lib.ses3d_tracker_scan.restype = i
            lib.ses3d_tracker_scan_smem_bytes.argtypes = [i] * 5
            lib.ses3d_tracker_scan_smem_bytes.restype = i
            u = ctypes.c_ulonglong
            lib.ses3d_loop_begin.argtypes = [p, p, p, i, p, p, ctypes.POINTER(u)]
            lib.ses3d_loop_begin.restype = i
            lib.ses3d_loop_next.argtypes = [p, u, p, p, i, p]
            lib.ses3d_loop_next.restype = i
            lib.ses3d_loop_end.argtypes = [p]
            lib.ses3d_loop_end.restype = i
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
