"""g++ builds of the port's native C++ sources at first use.

Each source under ``foundationdb_tpu_torch/native/`` is built with
``g++ -O3 -fPIC -std=c++17 -shared`` (``$CXX`` overrides the compiler) into
a git-ignored directory, ``build/native/`` at the repository root by
default. The library's file name carries a hash of the source and flags, so
an edited source is rebuilt; a build goes to a temporary file first, so
concurrent processes never load a partial library. A failed build raises.
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def lib_path(src: Path, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: Path, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed for {src.name}:\n{proc.stdout.decode(errors='replace')}"
        )
    os.replace(tmp, out)


def load(src: Path, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The library built from ``src``, built first if it is not there."""
    path = lib_path(src, build_dir)
    if not path.exists():
        build(src, path)
    return ctypes.CDLL(str(path))
