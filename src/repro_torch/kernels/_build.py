"""Build and load the port's CUDA kernels: ``nvcc`` into one shared
library per source, plain C entry points loaded with ``ctypes``.

Each source under ``csrc/`` is compiled for ``sm_90a`` at first use into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so a stale
library is never loaded.  ``build_all`` starts one ``nvcc`` per source at
once.  ``variant`` routes ``load`` to a build with other ``-D`` values of
a kernel's geometry constants (what ``torch_kernel_sweep.py`` times).
No ``--use_fast_math``: the grid math needs IEEE division, no
flush-to-zero and the accurate ``expf``.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"qmatmul": "qmatmul.cu", "kv_dequant": "kv_dequant.cu",
           "hgq_quantize": "hgq_quantize.cu", "wire_pack": "wire_pack.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries, one per source, for the life of the process (a
# library cannot be unloaded safely while the caching allocator may
# still hold work launched from it)
_LOADED: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# -D flags ``load`` builds a source with, by name: none outside ``variant``
_DEFINES: Dict[str, Tuple[str, ...]] = {}
# the ranks of a LocalMesh are threads: one of them builds and loads
_LOAD_LOCK = threading.Lock()


def build_dir() -> Path:
    """``<repo>/build/repro_torch_kernels``."""
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str, defines: Sequence[str] = ()) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    flags = " ".join((*NVCC_FLAGS, *defines))
    h = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{h}.so"


def build_all(names: Optional[Iterable[str]] = None,
              defines: Sequence[str] = ()) -> Dict[str, float]:
    """Compile every (or the named) source not yet built, one ``nvcc``
    each, all started together, with ``defines`` (``-DNAME=value``) added.
    Returns seconds per source built (0.0 when up to date).  Raises with
    the compiler's output on failure; the ptxas register/spill report
    lands in ``<lib>.log``."""
    names = list(SOURCES if names is None else names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    seconds = {}
    for name in names:
        out = _target(name, defines)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)              # atomic against a parallel builder
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def ptxas_report(name: str, defines: Sequence[str] = ()) -> str:
    """The compiler's register / shared-memory / spill lines for a built
    source (with ``defines`` added), each kernel's after the line that
    names it (empty if it was built by another process and left no
    log)."""
    log = _target(name, defines).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "registers" in line or "spill" in line
                     or "Compiling entry function" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _LOAD_LOCK:
        defines = _DEFINES.get(name, ())
        lib = _LOADED.get((name, defines))
        if lib is None:
            out = _target(name, defines)
            if not out.exists():
                build_all([name], defines)
            lib = ctypes.CDLL(str(out))
            _LOADED[(name, defines)] = lib
        return lib


@contextlib.contextmanager
def variant(name: str, defines: Sequence[str]):
    """Within the block, ``load(name)`` (and so every wrapper of that
    source) gives the source built with ``defines`` added: another value
    of a geometry constant, for a sweep."""
    with _LOAD_LOCK:
        _DEFINES[name] = tuple(defines)
    try:
        yield
    finally:
        with _LOAD_LOCK:
            _DEFINES.pop(name, None)


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
