"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The kernels have a plain C interface, so they compile with `nvcc` alone
(seconds, no PyTorch headers): one `nvcc -c` per source, all started
together, then one link into a shared library that is loaded with ctypes.
The build happens at first use, from the sources of this checkout only,
into `_build/` next to this file; the library's name carries a hash of the
sources and flags, so an edited source is never served stale.

Every kernel wrapper launches through `launch`, which runs the entry on
the device's current stream, raises on a CUDA error and counts the launch
in `LAUNCHES` by the kernel's name. Host builds (`host_library`) are not
counted.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("jv_assign.cu", "association_fold.cu", "tracker_scan.cu", "graph_loop.cu",
           "lm_prior.cu", "triangulation.cu", "pair_costs.cu", "scan_step.cu")
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
# Launches on the card by kernel name (jv_assign, association_fold,
# scan_costs, scan_extend, pair_costs, lm_trip, lm_marginals,
# tracker_scan, triangulation, triangulation_wide), counted by `launch`
# under _COUNT_LOCK (callers may launch from several threads).
LAUNCHES = collections.Counter()
_COUNT_LOCK = threading.Lock()
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


# The C entry points' argument types: (name, argtypes); restype int.
def _signatures() -> tuple:
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    return (
        ("ses3d_jv_assign", [p, p, p, i, i, i, i, i, p]),
        ("ses3d_jv_assign_smem_bytes", [i, i, i]),
        ("ses3d_association_fold", [p, p, p, p, p, i, i, i, i, i, i, f, f, p]),
        ("ses3d_association_fold_smem_bytes", [i, i, i, i]),
        ("ses3d_tracker_scan", [p] * 16 + [i] * 8 + [f, f, i, f, f, p]),
        ("ses3d_tracker_scan_smem_bytes", [i] * 5),
        ("ses3d_loop_begin", [p, p, p, i, p, p, ctypes.POINTER(u)]),
        ("ses3d_loop_next", [p, u, p, p, i, p]),
        ("ses3d_loop_end", [p, ctypes.POINTER(u)]),
        ("ses3d_stage_mark", [p, p, p, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]),
        ("ses3d_clock_probe", [p, p, p, ctypes.c_longlong]),
        ("ses3d_lm_trip", [p] * 13 + [i] * 3 + [f] * 4 + [p] * 3),
        ("ses3d_lm_marginals", [p] * 9 + [i, p]),
        ("ses3d_triangulate", [p] * 13 + [i, p]),
        ("ses3d_triangulate_smem_bytes", [i, i]),
        ("ses3d_triangulate_wide_bytes", [i]),
        ("ses3d_triangulation_host", [p] * 12 + [i]),
        ("ses3d_triangulation_host_smem_bytes", [i, i]),
        ("ses3d_triangulation_host_wide_bytes", [i]),
        ("ses3d_pair_costs", [p, p]),
        ("ses3d_pair_costs_host", [p]),
        ("ses3d_scan_costs", [p, p]),
        ("ses3d_scan_extend", [p, p]),
        ("ses3d_scan_costs_host", [p]),
        ("ses3d_scan_extend_host", [p]),
    )


def _load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the entry points it holds."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _signatures():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            _lib = _load(build())
    return _lib


# The kernels whose source also builds for the host with a C++ compiler
# (the macro HOST_MACRO selects that build): the tests' handle on their
# arithmetic where there is no card. -ffp-contract=off: no multiply-add is
# fused, as on the card (--fmad=false).
HOST_SOURCES = ("triangulation.cu", "scan_step.cu", "pair_costs.cu")
HOST_MACRO = "SES3D_HOST"
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
              "-Wall", "-Wextra", f"-D{HOST_MACRO}")
_host_lib = None


def host_library() -> ctypes.CDLL:
    """HOST_SOURCES built with $CXX (else g++) into one library under
    BUILD_DIR, at first use, and loaded."""
    global _host_lib
    with _LOAD_LOCK:
        if _host_lib is None:
            cxx = os.environ.get("CXX", "g++")
            h = hashlib.sha256(" ".join((cxx,) + HOST_FLAGS).encode())
            for name in HOST_SOURCES:
                h.update((CSRC / name).read_bytes())
            out = BUILD_DIR / f"libses3d_host_{h.hexdigest()[:16]}.so"
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [cxx, *HOST_FLAGS, "-o", str(tmp), *(str(CSRC / n) for n in HOST_SOURCES)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"{cxx} failed on {HOST_SOURCES} ({proc.returncode}):\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, out)
            _host_lib = _load(out)
    return _host_lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launch(name: str, entry: str, device, *args, what: str) -> None:
    """Launch kernel `name` through the C entry point `entry` of `library()`
    with `args` and, last, the current stream of `device`, made the current
    device while the entry runs (it queries and sets the device's
    attributes). Raises through `check` with `what`; counts the launch in
    LAUNCHES[name] only when it succeeded."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, what)
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
