"""Build-on-first-use ctypes loader for the port's native host library.

Counterpart of ``distributed_embeddings_tpu/native/loader.py``. The three
sources beside this file (``hashmap.cpp``: the `IntegerLookup` map;
``io.cpp``: the `RawBinaryDataset` prefetcher; ``host_apply.cpp``: the
offloaded buckets' row optimizers) are compiled by ``g++`` into one shared
library at first use. It lands in ``build/torch_ext/`` beside the CUDA
libraries (`ops.kernel_build.BUILD_DIR`), named by a hash of the sources
and the flags, so an edited source rebuilds and an unchanged one is
reused. The build writes a temporary name and renames it into place:
concurrent processes never load a half-written library. A failed build
raises with the compiler's output; nothing falls back.

`calls` counts the calls into the library by consumer: ``"integer_lookup"``
(each translation or query of a batch), ``"prefetch"`` (each read
submitted) and ``"host_apply"`` (each row-optimizer call).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

from distributed_embeddings_tpu_torch.ops.kernel_build import BUILD_DIR

__all__ = ["SOURCES", "CXX_FLAGS", "calls", "count", "library_path", "build",
           "load", "gxx_version"]

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("hashmap.cpp", "io.cpp", "host_apply.cpp")
# the JAX package's flags; -ffp-contract=off keeps each product and sum of
# the row optimizers rounded on its own (no fused multiply-add on a host
# that has one), as `ops.sparse_update.host_apply_rows_plain` rounds them
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-pthread",
             "-ffp-contract=off")

calls: Dict[str, int] = {"integer_lookup": 0, "prefetch": 0,
                         "host_apply": 0}

_LIB = None
_LOCK = threading.Lock()
_CALLS_LOCK = threading.Lock()


def count(consumer: str) -> None:
    """Add one to ``calls[consumer]`` (the consumers call from several
    threads: the ingest pipeline's workers and the step's)."""
    with _CALLS_LOCK:
        calls[consumer] += 1


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found on PATH: the native host library of "
            "distributed_embeddings_tpu_torch (native/*.cpp) is built from "
            "source at first use")
    return path


def gxx_version() -> str:
    """The first line of ``g++ --version``."""
    out = subprocess.run([_gxx(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def library_path() -> str:
    """The library of the sources as they stand, named by a hash of the
    flags and of every source."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"det_native-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless their library exists; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_gxx(), *CXX_FLAGS,
           *(os.path.join(NATIVE_DIR, s) for s in SOURCES), "-o", tmp]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("g++ failed to build the native host library:\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed, its functions typed."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        i64 = ctypes.c_int64
        p = ctypes.c_void_p
        f32 = ctypes.c_float
        lib.il_create.restype = p
        lib.il_create.argtypes = [i64]
        lib.il_destroy.argtypes = [p]
        lib.il_size.restype = i64
        lib.il_size.argtypes = [p]
        lib.il_lookup_or_insert.argtypes = [p, p, i64, p]
        lib.il_lookup.argtypes = [p, p, i64, p]
        lib.il_export_keys.argtypes = [p, p]
        lib.il_export_counts.argtypes = [p, p]
        lib.il_erase.argtypes = [p, p, i64, p]
        lib.il_high_water.restype = i64
        lib.il_high_water.argtypes = [p]
        lib.il_free_count.restype = i64
        lib.il_free_count.argtypes = [p]
        lib.il_export_free.argtypes = [p, p]

        lib.pf_create.restype = p
        lib.pf_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64, i64,
                                  p]
        lib.pf_destroy.argtypes = [p]
        lib.pf_submit.restype = p
        lib.pf_submit.argtypes = [p, i64, i64, i64, p]
        lib.pf_wait.restype = i64
        lib.pf_wait.argtypes = [p, p]
        lib.pf_read.restype = i64
        lib.pf_read.argtypes = [p, i64, i64, i64, p]

        lib.ha_sgd.argtypes = [p, i64, p, p, p, i64, f32]
        lib.ha_adagrad.argtypes = [p, p, i64, p, p, p, i64, f32, f32]
        lib.ha_adam.argtypes = [p, p, p, i64, p, p, p, i64, f32, f32, f32,
                                f32, f32, f32]
        _LIB = lib
        return _LIB
