"""Build-on-first-use for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers in
the build, so one source compiles in seconds). Libraries land in
``build/torch_ext/`` at the repository root, named by a hash of the source
and of the shared headers (``csrc/*.cuh``), so an edited source or header
rebuilds and an unchanged one is reused. `build` starts
one ``nvcc`` per source, all at once, and waits for every one. ``nvcc``
runs with ``-Xptxas -v``, and each library's compiler log (registers,
shared memory and spills per kernel) is kept beside it (`log_path`).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_ext")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of distributed_embeddings_tpu_torch are built from "
        "source on the machine with the card")


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the toolkit's release)."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    of every header in ``csrc/`` (which a source may include) and of the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for part in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, part), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """The compiler log of ``csrc/<name>.cu``, beside its library."""
    return library_path(name)[:-len(".so")] + ".log"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` each, all started together. Returns name -> library path.
    Each compiler log is written to `log_path`, on failure too. Raises
    with the compiler's output when a build fails."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        # temp name + atomic rename: a concurrent process never loads a
        # half-written library
        tmp = f"{p}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        with open(log_path(n), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu`` (its mangled name), from the
    compiler log: ``registers`` a thread, static ``shared_bytes`` and
    ``spill_bytes`` (spill stores + loads)."""
    with open(log_path(name)) as f:
        return parse_ptxas(f.read())


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """`ptxas_usage` of the text of an ``nvcc -Xptxas -v`` log."""
    usage: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernel = entry.group(1)
            usage[kernel] = dict(registers=0, shared_bytes=0, spill_bytes=0)
            continue
        if kernel is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            usage[kernel]["spill_bytes"] = (int(spills.group(1))
                                            + int(spills.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            usage[kernel]["registers"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                usage[kernel]["shared_bytes"] = int(smem.group(1))
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _LIBS[name] = lib
        return lib
