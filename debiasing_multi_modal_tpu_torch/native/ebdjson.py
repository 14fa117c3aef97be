"""ctypes binding of the native embedding-cache JSON parser and writer (the
port's own copy of ``debiasing_multi_modal_tpu/native/ebdjson.py``).

The C++ source is the repository's ``native/ebdjson.cpp`` (beside both
packages).  At first use it is compiled with ``g++ -O3 -std=c++17 -fPIC
-shared`` into the port's git-ignored build directory
(``debiasing_multi_modal_tpu_torch/build/``, where ``ops/cuda_build.py``
puts the kernels), under a file name that hashes the source, so an edited
parser is rebuilt and a stale one never loads.  The JAX binding's
``native/libebdjson.so`` is never opened or written.

:func:`load_embeddings_json` and :func:`save_embeddings_json` count their
successful calls (``.calls``), so a caller can tell that the native parser
ran (``data/embeddings_store.py`` falls back to its Python parser when this
module raises, as the JAX store does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "ebdjson.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """The library's path in the build directory; its name hashes the
    source."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libebdjson-{digest}.so")


def build() -> str:
    """Compile the parser if its library is missing; return its path.
    Raises ``FileNotFoundError`` without the source and
    ``subprocess.CalledProcessError`` (with g++'s output) on a failed build."""
    if not os.path.isfile(SOURCE):
        raise FileNotFoundError(SOURCE)
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.ebd_parse.restype = ctypes.c_void_p
        lib.ebd_parse.argtypes = [ctypes.c_char_p] * 3
        lib.ebd_error.restype = ctypes.c_char_p
        lib.ebd_error.argtypes = [ctypes.c_void_p]
        for name in ("ebd_n", "ebd_dim"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.ebd_embeddings.restype = ctypes.POINTER(ctypes.c_float)
        lib.ebd_embeddings.argtypes = [ctypes.c_void_p]
        for name in ("ebd_y", "ebd_place", "ebd_group", "ebd_split", "ebd_y_pred"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(ctypes.c_int32)
            fn.argtypes = [ctypes.c_void_p]
        lib.ebd_filename.restype = ctypes.c_char_p
        lib.ebd_filename.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ebd_free.argtypes = [ctypes.c_void_p]
        lib.ebd_write.restype = ctypes.c_int
        lib.ebd_write.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return lib


def load_embeddings_json(path: str, dataset: str):
    """Parse a clip.json cache into an EmbeddingTable with the C++ parser."""
    from debiasing_multi_modal_tpu_torch.data.embeddings_store import (
        _JSON_KEYS,
        EmbeddingTable,
    )

    ykey, pkey = _JSON_KEYS[dataset]
    lib = _load_lib()
    handle = lib.ebd_parse(path.encode(), ykey.encode(), pkey.encode())
    if not handle:
        # allocation failed even for the error Table (native OOM guard)
        raise MemoryError("ebdjson: native parser out of memory")
    try:
        err = lib.ebd_error(handle)
        if err:
            raise ValueError(f"ebdjson: {err.decode()}")
        n = lib.ebd_n(handle)
        d = lib.ebd_dim(handle)

        def as_np(ptr, shape, dtype):
            # an empty std::vector's data() is NULL: as_array would raise
            # on a valid empty table
            if n == 0 or not ptr:
                return np.zeros(shape, dtype)
            return np.ctypeslib.as_array(ptr, shape=shape).astype(dtype, copy=True)

        def col(fn):
            return as_np(fn(handle), (n,), np.int32)

        table = EmbeddingTable(
            filenames=np.asarray([lib.ebd_filename(handle, i).decode() for i in range(n)]),
            y=col(lib.ebd_y),
            place=col(lib.ebd_place),
            group=col(lib.ebd_group),
            split=col(lib.ebd_split),
            y_pred=col(lib.ebd_y_pred),
            embeddings=as_np(lib.ebd_embeddings(handle), (n, d), np.float32),
        )
    finally:
        lib.ebd_free(handle)
    load_embeddings_json.calls += 1
    return table


def save_embeddings_json(path: str, table, dataset: str) -> None:
    """Write an EmbeddingTable in the reference clip.json schema with the
    C++ writer."""
    from debiasing_multi_modal_tpu_torch.data.embeddings_store import _JSON_KEYS

    ykey, pkey = _JSON_KEYS[dataset]
    lib = _load_lib()

    def col(a):
        arr = np.ascontiguousarray(a, np.int32)
        return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    names = b"\0".join(str(fn).encode() for fn in table.filenames) + b"\0"
    emb = np.ascontiguousarray(table.embeddings, np.float32)
    keep = [col(table.y), col(table.place), col(table.group), col(table.split),
            col(table.y_pred)]  # the buffers stay referenced through the call
    rc = lib.ebd_write(
        path.encode(), ykey.encode(), pkey.encode(), names,
        keep[0][1], keep[1][1], keep[2][1], keep[3][1], keep[4][1],
        emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(table), emb.shape[1] if emb.ndim == 2 else 0,
    )
    if rc != 0:
        raise IOError(f"ebdjson writer failed (rc={rc}) for {path!r}")
    save_embeddings_json.calls += 1


load_embeddings_json.calls = 0
save_embeddings_json.calls = 0
