"""Build a CUDA source of the port into a shared library and load it.

Each kernel family keeps its CUDA C++ under ``csrc/`` with a plain C
interface.  At first use :func:`compile_library` compiles it with ``nvcc``
for ``sm_90a`` into ``build/repro_torch/`` at the root of the checkout (the
file name carries a hash of the source, of every header it includes with
``#include "..."``, such as ``kernels/csrc/mma_tile.cuh``, and of the
flags, so an edited kernel or header is rebuilt) and loads it with
``ctypes``.  Nothing here runs when a module is imported: the CPU tests
import every module on machines with no ``nvcc`` and no card.  Separate
sources compile independently, so callers may build several libraries at
once from threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

# src/repro_torch/kernels/build.py -> checkout root
_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SMEM = 232448          # bytes a block may use on Hopper (227 KB)
# a launcher's status: stage * STAGE_BASE + the CUDA error the stage met
# (csrc/launch_status.cuh)
STAGE_BASE = 100000
STAGES = {1: "its arguments", 2: "binding the thread to the device",
          3: "fetching the tensor-map encoder", 4: "encoding a tensor map",
          5: "granting dynamic shared memory", 6: "a device attribute query",
          7: "zeroing a counter", 8: "the launch",
          9: "allocating, zeroing or freeing a symmetric heap",
          10: "exporting, opening or closing a CUDA IPC handle"}


def _nvcc(src: Path) -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            f"nvcc not found: {src.name} is built at first use on a machine "
            f"with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(src: Path, seen=None) -> Dict[Path, bytes]:
    """``src`` and the local headers it includes, transitively: path ->
    bytes, in the order they are first met."""
    seen = {} if seen is None else seen
    src = src.resolve()
    if src in seen:
        return seen
    seen[src] = src.read_bytes()
    for name in _INCLUDE.findall(seen[src]):
        dep = src.parent / name.decode()
        if dep.exists():
            _sources(dep, seen)
    return seen


def library_tag(src: Path) -> str:
    """Hash of what the build of ``src`` depends on: its bytes, the bytes
    of each header it includes, and the nvcc flags."""
    h = hashlib.sha1()
    for path, code in _sources(src).items():
        h.update(path.name.encode() + b"\0" + code)
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def compile_library(src: Path, stem: str) -> Tuple[ctypes.CDLL, Dict]:
    """Compile ``src`` into ``build/repro_torch/lib<stem>_<hash>.so`` when
    that library is missing, and load it.  Returns the library and what the
    build did: its path, seconds, whether it compiled, and the ptxas
    report (registers, shared memory and spills of every kernel)."""
    out = BUILD_DIR / f"lib{stem}_{library_tag(src)}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(src), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} ({res.returncode}):\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
        log = res.stdout + res.stderr
    info = dict(path=str(out), seconds=time.perf_counter() - t0,
                built=bool(log), ptxas=log)
    return ctypes.CDLL(str(out)), info


def launch_error(what: str, status: int) -> RuntimeError:
    """The error a wrapper raises for a launcher's non-zero ``status``: the
    check that refused the launch and the CUDA error it met there (a
    ``cudaError_t``, or the ``CUresult`` of ``cuTensorMapEncodeTiled``
    for the tensor-map stages)."""
    stage, err = divmod(status, STAGE_BASE)
    return RuntimeError(f"{what} kernel launch failed at "
                        f"{STAGES.get(stage, f'stage {stage}')}: CUDA error "
                        f"{err}")
