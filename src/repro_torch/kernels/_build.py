"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>-<digest>.so``
with a plain C interface (pointers and the stream as ``void*``), loaded
with ``ctypes``.  The digest covers the source, every shared header of
``csrc/`` and the flags, so an edited kernel never loads a stale library.  Libraries go to
``build/repro_torch/`` at the root of the checkout (git-ignored).

Nothing here runs at import: the CPU tests import every module of the
package on machines without ``nvcc``.
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("conv_stem", "resblock_fused", "block_chain", "matmul_int8",
           "flash_attention", "selective_scan", "conv2d_int8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# link flags of single kernels: matmul_int8 encodes TMA tensor maps with
# cuTensorMapEncodeTiled from libcuda
LINK_FLAGS = {"matmul_int8": ("-lcuda",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for part in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS.get(name, ())).encode())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Sequence[str] = KERNELS,
          force: bool = False) -> Dict[str, float]:
    """Compile every kernel of ``names`` whose library is missing (every
    one with ``force``), one ``nvcc`` per source, all started together.
    Returns the seconds each build took (0.0 when the library existed).
    Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log").open("wb")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *LINK_FLAGS.get(name, ())]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, log)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib_path(name))
    if failed:
        msgs = [f"--- {n}\n{build_log(n)}" for n in failed]
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n" +
                           "\n".join(msgs))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output of the last build of ``name`` (registers, shared
    memory and spills per kernel from ``-Xptxas -v``)."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text(errors="replace") if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            if not lib_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
