"""Builds the CUDA kernels from ``csrc/`` with nvcc at first use.

Each ``csrc/*.cu`` compiles to an object with its own nvcc process, all
started together, and the objects link into one shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libkbt_kernels.so *.o

into ``kube_batch_tpu_torch/build/``.  ``--use_fast_math`` is never
passed: it would fold K2's ``x + 0.0f`` (the -0.0 canonicalisation) and
relax the IEEE compares the kernels rely on.  The library is rebuilt
when the hash of the sources and flags changes; a failed build raises
with nvcc's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
LIB_NAME = "libkbt_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float           # wall time of this call's compile + link
    ptxas: List[str]         # per kernel: registers, shared memory, spills


def nvcc_path() -> str:
    """nvcc from $PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")


def _inputs() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for p in _inputs():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Runs the commands concurrently; returns their outputs, or raises
    with the output of the first that failed (after all have ended)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}"
            )
    return outs


def build(force: bool = False) -> BuildInfo:
    """The kernel library, compiled if it is missing or stale (or if
    ``force``)."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return BuildInfo(lib, 0.0, [])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        outs = _run_all([
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC_DIR),
             "-c", str(s), "-o", str(o)]
            for s, o in zip(srcs, objs)
        ])
        tmp_lib = Path(tmp) / LIB_NAME
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                   *map(str, objs)]])
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    ptxas = [ln for out in outs for ln in ptxas_summary(out)]
    return BuildInfo(lib, time.perf_counter() - t0, ptxas)


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel in a namespace whose template
    arguments are integers, ``name`` of one with no template arguments; the
    mangled name itself if it does not read so."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, None
    while i < len(mangled) and mangled[i].isdigit():  # <length><identifier>...
        m = re.match(r"\d+", mangled[i:])
        n = int(m.group(0))
        i += len(m.group(0))
        name = mangled[i:i + n]
        i += n
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    if name is not None and args is None and mangled[i:i + 1] == "E":
        return name
    if name is None or args is None:
        return mangled
    values = re.findall(r"Li(-?\d+)E", args.group(1))
    return f"{name}<{', '.join(values)}>"


def ptxas_summary(out: str) -> List[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output:
    its name, then the registers, shared memory and spill figures."""
    lines, name, spill = [], None, ""
    for ln in out.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            name, spill = _kernel_name(entry.group(1)), ""
        elif "spill stores" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            used = ln.split(":", 1)[1].strip()
            lines.append(f"{name}: {used}; {spill}" if spill else f"{name}: {used}")
            name = None
    return lines


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature
    declared (pointers and the stream as ``c_void_p``, so none is cut to
    32 bits)."""
    lib = ctypes.CDLL(str(build().path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.kbt_masked_best_node.argtypes = [P] * 7 + [I] * 5 + [P] * 4 + [P]
    lib.kbt_masked_best_node.restype = I
    lib.kbt_masked_topk_blocks.argtypes = [P] * 6 + [I] * 4 + [P] * 4 + [P]
    lib.kbt_masked_topk_blocks.restype = I
    lib.kbt_enqueue_gate.argtypes = [P] * 4 + [I] * 2 + [P] * 2
    lib.kbt_enqueue_gate.restype = I
    lib.kbt_error_string.argtypes = [I]
    lib.kbt_error_string.restype = ctypes.c_char_p
    return lib
