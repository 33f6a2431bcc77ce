"""The port's native augment library builds once and atomically when
several processes build it at once (runtime/native.py)."""

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

from rgb_proprioceptive_pose_estimator_tpu_torch.runtime import native


def test_concurrent_builds_compile_once_and_never_leave_a_partial_file(
        tmp_path, monkeypatch):
    lib = str(tmp_path / "librppe_augment.so")
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(native, "_INFO", lib + ".buildinfo")
    monkeypatch.setattr(native, "_BUILD_LOCK", lib + ".lock")
    compiles = []
    run = native.subprocess.run

    def counted_run(cmd, **kw):
        compiles.append(cmd[-1])
        # the compiler writes a private file, never the library itself
        assert cmd[-1] != lib and cmd[-1].startswith(lib + ".")
        return run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", counted_run)
    with ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: native.build(), range(4)))
    assert paths == [lib] * 4
    assert len(compiles) == 1
    assert sorted(os.listdir(tmp_path)) == [
        "librppe_augment.so", "librppe_augment.so.buildinfo",
        "librppe_augment.so.lock"]
    assert native._is_current(native._buildinfo())
    ctypes.CDLL(lib)
    # a current library is reused without taking the lock or compiling
    assert native.build() == lib and len(compiles) == 1
