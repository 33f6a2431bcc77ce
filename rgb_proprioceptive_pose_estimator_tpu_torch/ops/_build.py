"""Build the CUDA sources under ``csrc/`` with nvcc, at first use.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a shared
library with a plain C interface that ``ctypes`` loads (no PyTorch headers,
so a build takes seconds). The hash covers the source and the nvcc command,
so a changed source is rebuilt and an unchanged one is reused. All stale
sources compile at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under /usr/local/cuda. Raises if none."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the port's "
            "CUDA kernels are built from csrc/ at first use and need the "
            "CUDA toolkit")
    return nvcc


def sources() -> List[str]:
    """Names of the kernel sources (csrc/<name>.cu)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile the named sources (all of csrc/ by default) that have no
    library for their current hash, every nvcc started before any is
    waited for. Returns {name: library path}; raises with nvcc's output if
    a build fails."""
    names = list(names) or sources()
    paths = {name: library_path(name) for name in names}
    stale = {n: p for n, p in paths.items() if not p.exists()}
    if not stale:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in stale.items():
        # a private output name, renamed into place when done, so that
        # a concurrent build never loads a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"csrc/{name}.cu:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, stale[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
