"""Host C for the Go-loop denominator (``native/go_pass.c``).

The library is built at first use with the system C compiler:

    cc -O2 -fPIC -Wall -Wextra -ffp-contract=off -shared \\
       -o kube_batch_tpu_torch/build/libgopass.so native/go_pass.c -lpthread -lm

into ``kube_batch_tpu_torch/build/`` (never into the source tree), and
rebuilt when the hash of the source and the flags changes, as
``ops/_build.py`` does for the kernels.  ``-ffp-contract=off`` keeps the
scorer bit-equal to the numpy pass: an FMA-contracted multiply-add drifts
by ULPs and can flip argmax ties.  A failed build raises with the
compiler's output; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

SRC = Path(__file__).resolve().with_name("go_pass.c")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
LIB_NAME = "libgopass.so"

CFLAGS = ["-O2", "-fPIC", "-Wall", "-Wextra", "-ffp-contract=off", "-shared"]
LDLIBS = ["-lpthread", "-lm"]

_D = ctypes.c_void_p
_I64 = ctypes.c_int64

#: serializes builds and loads; one library per built path
_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}
#: the C pool is one process-wide object: one pooled run at a time
POOL_LOCK = threading.Lock()


def compiler() -> str:
    """``$CC`` if set, else ``cc`` from ``$PATH``; raises when neither is there."""
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise RuntimeError("no C compiler: set CC or put cc on PATH")
    return cc


def source_hash(src: Path = SRC) -> str:
    h = hashlib.sha256(" ".join(CFLAGS + LDLIBS).encode())
    h.update(Path(src).read_bytes())
    return h.hexdigest()


def build(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """The shared library of ``src`` in ``build_dir``, compiled if it is
    missing or its stamp differs from the source's hash."""
    src, build_dir = Path(src), Path(build_dir)
    lib = build_dir / LIB_NAME
    stamp = build_dir / (LIB_NAME + ".sha256")
    digest = source_hash(src)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = Path(tmp) / LIB_NAME
        cmd = [compiler(), *CFLAGS, "-o", str(out), str(src), *LDLIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except OSError as e:
            raise RuntimeError(f"C build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"C build failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(out, lib)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    return lib


def load(src: Path = SRC, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The built library with its signatures set (built on first use)."""
    with _LOCK:
        path = build(src, build_dir)
        lib: Optional[ctypes.CDLL] = _LIBS.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            for name in ("go_pass_single", "go_pass_pooled"):
                fn = getattr(lib, name)
                fn.restype = _I64
                fn.argtypes = [_D, _D, _D, _D, _I64, _I64]
            lib.go_pass_pool_init.restype = ctypes.c_int
            lib.go_pass_pool_init.argtypes = [ctypes.c_int]
            lib.go_pass_pool_shutdown.restype = None
            lib.go_pass_pool_shutdown.argtypes = []
            lib.go_loop_run.restype = _I64
            lib.go_loop_run.argtypes = [_D] * 6 + [_I64, _I64, _I64, ctypes.c_int, _D, _D]
            _LIBS[path] = lib
        return lib


def pool_init(lib: ctypes.CDLL, threads: int) -> None:
    """Starts the C pool of ``threads`` workers; raises if it cannot."""
    if lib.go_pass_pool_init(threads) != 0:
        raise RuntimeError(f"go_pass_pool_init({threads}) failed")


__all__ = ["load", "build", "pool_init", "POOL_LOCK", "SRC", "BUILD_DIR", "LIB_NAME"]
