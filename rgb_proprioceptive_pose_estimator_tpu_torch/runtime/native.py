"""ctypes bindings + on-demand build of the native host-augment engine
(runtime/csrc/augment.cc).

No pybind11 in the image (SURVEY.md env facts), so the C ABI + ctypes is
the binding layer. The library is compiled on first use with g++ and cached
next to the source; builds are best-effort -- every caller must handle
`available() == False` and fall back to the numpy backend.

Several processes may build at once (pytest-xdist workers on a fresh
tree): one builds under an flock on a lock file beside the library, into
a private temporary file that is renamed onto the library, so no process
ever loads a half-written file; the others wait and reuse its build.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "augment.cc")
_LIB = os.path.join(_DIR, "librppe_augment.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_cmd(out: str = _LIB) -> list:
    # -march=native: the lib is compiled on first use on the host that
    # runs it (the .buildinfo check below prevents a stale lib built on a
    # different host/flags from being reused -- a foreign-ISA .so would
    # SIGILL mid-training). Override flags with RPPE_NATIVE_CFLAGS.
    flags = os.environ.get(
        "RPPE_NATIVE_CFLAGS", "-O3 -march=native -funroll-loops").split()
    return ["g++", *flags, "-std=c++17", "-shared", "-fPIC", "-pthread",
            "-fvisibility=hidden", _SRC, "-o", out]


def _cpu_id() -> str:
    """CPU model identifier -- the thing -march=native actually keys on
    (hostnames churn in containers; machine() misses ISA differences)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "Processor")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine()


def _buildinfo() -> str:
    import hashlib

    with open(_SRC, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    return " ".join([src_hash, _cpu_id(), *_build_cmd()])


_INFO = _LIB + ".buildinfo"
_BUILD_LOCK = _LIB + ".lock"


def _is_current(info: str) -> bool:
    """The library exists and its .buildinfo records ``info``."""
    try:
        with open(_INFO) as f:
            return f.read() == info and os.path.exists(_LIB)
    except OSError:
        return False


def build(force: bool = False) -> Optional[str]:
    """Compile the shared library; returns its path or None on failure.

    The cached .so is reused only when source hash, build flags, and host
    all match the recorded .buildinfo. The library and then its .buildinfo
    are each renamed into place whole, under the build lock."""
    try:
        info = _buildinfo()
    except OSError:
        return None   # csrc/ not shipped: callers fall back to numpy
    if not force and _is_current(info):
        return _LIB
    tmp = f"{_LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(_BUILD_LOCK, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            # another process may have built it while this one waited
            if not force and _is_current(info):
                return _LIB
            subprocess.run(_build_cmd(tmp), check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, _LIB)
            with open(tmp, "w") as f:
                f.write(info)
            os.replace(tmp, _INFO)
        return _LIB
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = os.environ.get("RPPE_NATIVE_LIB") or build()
        if path is None or not os.path.exists(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.rppe_init.argtypes = [ctypes.c_int]
        lib.rppe_init.restype = ctypes.c_int
        lib.rppe_augment_batch.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int, i32p, u8p, f32p, ctypes.c_int,
        ]
        lib.rppe_augment_batch.restype = None
        lib.rppe_center_crop_resize_batch.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.rppe_center_crop_resize_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def augment_batch(frames: np.ndarray, out_hw: int, crops: np.ndarray,
                  flips: np.ndarray, jitter: np.ndarray,
                  threads: int = 0) -> np.ndarray:
    """frames (N, sh, sw, C) uint8 + per-frame params -> (N, out, out, C).

    crops: (N, 4) int32 [y0, x0, crop_h, crop_w]; flips: (N,) uint8;
    jitter: (N, 4) float32 brightness/contrast/saturation/hue
    (<=0 skips b/c/s; hue 0.0 = identity)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native augment library unavailable")
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, sh, sw, c = frames.shape
    out = np.empty((n, out_hw, out_hw, c), dtype=np.uint8)
    lib.rppe_augment_batch(
        frames, n, sh, sw, c, out, out_hw, out_hw,
        np.ascontiguousarray(crops, np.int32),
        np.ascontiguousarray(flips, np.uint8),
        np.ascontiguousarray(jitter, np.float32),
        threads)
    return out


def center_crop_resize_batch(frames: np.ndarray, out_hw: int,
                             threads: int = 0) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native augment library unavailable")
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, sh, sw, c = frames.shape
    out = np.empty((n, out_hw, out_hw, c), dtype=np.uint8)
    lib.rppe_center_crop_resize_batch(frames, n, sh, sw, c, out, out_hw,
                                      out_hw, threads)
    return out
