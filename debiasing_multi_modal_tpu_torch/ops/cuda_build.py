"""Build and load the port's CUDA kernels (``csrc/*.cu``, which may include
the shared ``csrc/*.cuh`` headers).

Each source is a plain C interface compiled by ``nvcc`` for ``sm_90a`` into a
shared library and loaded with ``ctypes``.  Builds happen at first use (or
all at once, in parallel, through :func:`build_all`) into ``build/`` inside
the package, which ``.gitignore`` lists; a library's file name carries a hash
of its source, so an edited kernel is rebuilt and a stale one never loads.

Nothing here runs at import time: importing the package loads no library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}  # typed C functions, by (library, symbol)
build_logs: Dict[str, str] = {}  # the compiler's output, by library built in this process


def kernel_names() -> List[str]:
    """Every kernel source under ``csrc/``, by stem."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> str:
    """The library's path; its name hashes the source and every shared
    header (``csrc/*.cuh``), so an edit to either rebuilds it."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str] = None) -> float:
    """Compile every missing library with one ``nvcc`` per source, all
    started together; return the wall seconds.  Raises on a failed build
    with the compiler's output."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names if names is not None else kernel_names():
        out = library_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            build_logs[name] = log
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def ptxas_usage(name: str) -> List[dict]:
    """Registers, spill bytes and stack of every kernel in library ``name``,
    read from ``-Xptxas=-v`` in its build log (empty if this process did not
    build it)."""
    rows, current = [], None
    for line in build_logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = {"function": m.group(1)}
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return rows


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if missing)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def _entry(name: str, symbol: str, n_ptrs: int, n_ints: int, n_floats: int):
    """The C function ``symbol`` of library ``name``, typed once as
    ``n_ptrs`` pointers, ``n_ints`` ints, ``n_floats`` floats and a trailing
    stream pointer, returning an int (the CUDA error code)."""
    key = (name, symbol)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def launch(name: str, symbol: str, tensors, ints, device, floats=()) -> None:
    """Call the C entry ``symbol`` of library ``name`` with the tensors'
    pointers (``None`` passes NULL), the ints, the floats (as C ``float``),
    and ``device``'s current stream; raise on a nonzero CUDA error, which a
    refused launch returns."""
    import torch

    fn = _entry(name, symbol, len(tensors), len(ints), len(floats))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in tensors), *ints, *floats,
                 stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def loaded() -> List[str]:
    """Names of the kernel libraries loaded in this process."""
    return sorted(_libs)
