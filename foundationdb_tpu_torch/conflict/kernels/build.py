"""Build and load the conflict-grid CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/kernels/`` at the
repository root (git-ignored), and loaded with ``ctypes``. All sources are
compiled in parallel, at first use: importing this module builds nothing,
so the CPU tests import it on a machine with no ``nvcc``. A library's file
name carries a hash of its source and of the headers (``csrc/*.cuh``, the
phases' device code that ``scan.cu`` shares with the standalone kernels),
so an edited kernel is rebuilt. ``scan.cu``'s grid-wide barrier
(``cooperative_groups`` ``grid.sync()``) needs no relocatable device code
(``-rdc``) since CUDA 11, so it builds with the same flags.
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

from ..errors import KernelBuildError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("history", "intra_batch", "stage", "merge", "maint", "search", "scan")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: name → (library, argtypes); every one returns the
# cudaError_t of cudaGetLastError() after its launches (the occupancy
# query, the launch's preparation, peer access, the inboxes' allocation
# and copy, that of their calls; fdb_spread_args_bytes a size)
SIGNATURES = {
    "fdb_history": ("history", [_P] * 10 + [_I] * 7 + [_P]),
    "fdb_history_parts": ("history", [_P] * 12 + [_I] * 8 + [_P]),
    "fdb_intra_batch": ("intra_batch", [_P] * 7 + [_I] * 6 + [_P]),
    "fdb_stage": ("stage", [_P] * 13 + [_I] * 9 + [_P]),
    "fdb_merge": ("merge", [_P] * 8 + [_I] * 2 + [_P] * 2 + [_I] * 6 + [_P]),
    "fdb_reshard": ("maint", [_P] * 11 + [_I] * 7 + [_P]),
    "fdb_rebase": ("maint", [_P] * 6 + [_I] * 4 + [_P]),
    "fdb_search": ("search", [_P] * 3 + [_I] * 3 + [_P]),
    "fdb_resolve_many": ("scan", [_P] * 31 + [_I] * 18 + [_P]),
    "fdb_spread_prepare": ("scan", [_P, _I] + [_P] * 11 + [_L, _P] + [_P] * 2 + [_L] + [_I] * 24 + [_P]),
    "fdb_spread_launch": ("scan", [_I] + [_P] * 5),
    "fdb_spread_args_bytes": ("scan", []),
    "fdb_scan_occupancy": ("scan", [_I] * 2 + [_P]),
    "fdb_peer_access": ("scan", [_I, _I, _P]),
    "fdb_dev_alloc": ("scan", [_L, _P]),
    "fdb_dev_free": ("scan", [_P]),
    "fdb_host_alloc": ("scan", [_L, _P]),
    "fdb_host_free": ("scan", [_P]),
    "fdb_copy": ("scan", [_P, _P, _L]),
}

_lock = threading.Lock()
_fns: dict = {}
build_log: dict[str, str] = {}  # nvcc output (ptxas register/smem report)
build_seconds: float = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (CUDA_HOME unset and no nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # the phases' device code, which scan.cu shares
        h.update(header.read_bytes())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load() -> dict:
    """Build (if needed) and load every kernel library; returns the C
    functions by name. Raises ``KernelBuildError`` with nvcc's output if a
    build fails, and when a library does not load."""
    global build_seconds
    with _lock:
        if _fns:
            return _fns
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                tmp,
                out,
            )
        failed = []
        for name, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            build_log[name] = log.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{build_log[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise KernelBuildError("nvcc failed for " + "\n".join(failed))
        try:
            libs = {name: ctypes.CDLL(str(_lib_path(name))) for name in SOURCES}
        except OSError as e:
            raise KernelBuildError(f"a kernel library did not load: {e}") from e
        fns = {}
        for fn_name, (lib, argtypes) in SIGNATURES.items():
            fn = getattr(libs[lib], fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[fn_name] = fn
        build_seconds = time.perf_counter() - t0
        _fns.update(fns)
        return _fns
