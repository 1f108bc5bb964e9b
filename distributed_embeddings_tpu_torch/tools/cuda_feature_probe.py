"""The Hopper feature ladder: counterpart of ``tools/tpu_mosaic_probe.py``.

The TPU probe bisects a toolchain failure: it compiles a ladder of minimal
Pallas kernels, each adding one feature the production kernels rely on,
runs every rung even after one failed, and reports the whole matrix. This
ladder does the same for the Hopper features the port's kernels are to be
built from, one source and one ``nvcc`` per rung (``csrc/probe_*.cu``), so a
fault in one of them (a wrong libcuda entry point, a misaligned box, a
missing barrier fence) shows as one named rung and not as a hang inside a
large kernel:

  1. vmem              static shared memory; the sm_90a target (control)
  2. anyspace          a TMA tensor map as a kernel parameter; shared memory
                       above 48 KB
  3. dma               a bulk asynchronous copy completed on an mbarrier
  4. dyn_dma           cp.async of a row chosen at run time
  5. prefetch          a TMA tensor load at a runtime coordinate
  6. loop_dma          8 TMA loads in flight on 8 mbarriers
  7. blockspec_gather  index-driven tiles, a carried accumulator, in place
  8. rmw_scatter       `cuda_sparse.sgd_rows` at lr -1 (the TPU probe's
                       scatter rung)
  9. tiled_kernels     `cuda_tiled`'s stream kernels and sorted gather at
                       the JAX package's `_validate_tiled` inputs

Rungs 1-7 run on two input sets: the JAX rung's own constants, and seeded
inputs over distinct-row tables (``t[r, c] = r * 128 + c``, exact in
float32), where a wrong row or column shows. Every kernel output is held
bit-equal against its plain PyTorch version (the TPU rung's own check is
held too).

Each wrapper checks its inputs, takes its plain version only for CPU
tensors, and on CUDA tensors launches its kernel on the current stream or
raises. ``launches`` counts kernel launches per kernel.

    python -m distributed_embeddings_tpu_torch.tools.cuda_feature_probe
        [--device cuda|cpu]

prints the toolkit's release, one line per rung (ok or FAIL with the head
of the error; build seconds, registers, static shared memory and spills
from the compiler's log; device microseconds per run of the rung's
kernels), then the matrix as JSON, and exits 1 if any rung failed.
"""

import argparse
import ctypes
import functools
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.ops import (cuda_sparse, cuda_tiled,
                                                  kernel_build)
from distributed_embeddings_tpu_torch.ops.cuda_sparse import (_check_same,
                                                              _on_cuda,
                                                              _stream)
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    canonical_id_sort, segment_bounds)
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           resolve_device)

__all__ = ["vmem", "anyspace", "dma", "dyn_dma", "prefetch", "loop_dma",
           "blockspec_gather", "vmem_plain", "anyspace_plain", "dma_plain",
           "dyn_dma_plain", "prefetch_plain", "loop_dma_plain",
           "blockspec_gather_plain", "rung_inputs", "Rung", "RUNGS",
           "KERNEL_RUNGS", "run_ladder", "main", "launches"]

# the JAX ladder's shapes: table rows, width, block rows; the rows of the
# prefetch and loop rungs; the blockspec rung's tile rows, id chunk, steps
# (and chunks) and table tiles
V, W, B = 4096, 128, 256
PREFETCH_N, LOOP_N = 4, 8
TILE, CHUNK, STEPS, TILES = 8, 128, 2, 4

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# argument types per kernel (the stream pointer comes last)
_ARGTYPES = {
    "probe_vmem": [_P, _I64, _P, _P],
    "probe_anyspace": [_P, _I64, _P, _P],
    "probe_dma": [_P, _P, _P],
    "probe_dyn_dma": [_P, _P, _I64, _P, _P],
    "probe_prefetch": [_P, _I64, _P, _I64, _P, _P],
    "probe_loop_dma": [_P, _I, _P, _I64, _P, _P],
    "probe_blockspec_gather": [_P, _P, _P, _P, _P, _P],
}

# kernel launches made by each wrapper on CUDA tensors
launches: Dict[str, int] = dict.fromkeys(_ARGTYPES, 0)


def _kernel(kernel: str):
    """The C entry point of ``csrc/<kernel>.cu``, built first if needed."""
    fn = getattr(kernel_build.load(kernel), f"{kernel}_f32")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[kernel]
        fn.restype = ctypes.c_int
    return fn


def _count(kernel: str, err: int) -> None:
    """Raise on a refused launch (a negative code is libcuda's CUresult),
    else count it."""
    if err != 0:
        what = f"CUresult {-err}" if err < 0 else f"CUDA error {err}"
        raise RuntimeError(f"{kernel} launch failed: {what}")
    launches[kernel] += 1


def _check(what: str, *specs) -> None:
    """Each (tensor, dtype, shape) as the ladder runs it: the rungs take
    one set of shapes. Contiguous, on one device."""
    for t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: takes {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
    _check_same(what, *(t for t, _, _ in specs))


def _aligned(what: str, t: torch.Tensor) -> None:
    """The copy engines read from 16-byte aligned addresses."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the table must be 16-byte aligned")


F32, I32 = torch.float32, torch.int32


# ------------------------------------------------------------------ rungs
def vmem_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `vmem`."""
    return x * 2.0


def vmem(x: torch.Tensor) -> torch.Tensor:
    """out = 2 * x for float32 x [256, 128]."""
    _check("vmem", (x, F32, (B, W)))
    if not _on_cuda("vmem", x):
        return vmem_plain(x)
    fn = _kernel("probe_vmem")
    out = torch.empty_like(x)
    if x.shape[0]:
        _count("probe_vmem", fn(x.data_ptr(), x.shape[0], out.data_ptr(),
                                _stream(x)))
    return out


def anyspace_plain(t: torch.Tensor) -> torch.Tensor:
    """Plain version of `anyspace`."""
    return torch.zeros((B, W), dtype=torch.float32, device=t.device)


def anyspace(t: torch.Tensor) -> torch.Tensor:
    """out [256, 128] = zeros; the kernel takes a TMA tensor map over
    float32 t [4096, 128] (box 256 x 128) and does not use it."""
    _check("anyspace", (t, F32, (V, W)))
    if not _on_cuda("anyspace", t):
        return anyspace_plain(t)
    fn = _kernel("probe_anyspace")
    _aligned("anyspace", t)
    out = torch.empty((B, W), dtype=torch.float32, device=t.device)
    _count("probe_anyspace", fn(t.data_ptr(), t.shape[0], out.data_ptr(),
                                _stream(t)))
    return out


def dma_plain(t: torch.Tensor) -> torch.Tensor:
    """Plain version of `dma`."""
    return t[:B].clone()


def dma(t: torch.Tensor) -> torch.Tensor:
    """out [256, 128] = t[0:256] for float32 t [4096, 128], through one
    bulk copy of the 128 KB slab."""
    _check("dma", (t, F32, (V, W)))
    if not _on_cuda("dma", t):
        return dma_plain(t)
    fn = _kernel("probe_dma")
    _aligned("dma", t)
    out = torch.empty((B, W), dtype=torch.float32, device=t.device)
    _count("probe_dma", fn(t.data_ptr(), out.data_ptr(), _stream(t)))
    return out


def dyn_dma_plain(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain version of `dyn_dma`."""
    return t.index_select(0, idx[:1].long())


def dyn_dma(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out [1, 128] = t[idx[0]] for int32 idx [1] and float32 t [4096,
    128]; a row outside [0, 4096) raises on the CPU and traps on the
    card."""
    _check("dyn_dma", (idx, I32, (1,)), (t, F32, (V, W)))
    if not _on_cuda("dyn_dma", t):
        return dyn_dma_plain(idx, t)
    fn = _kernel("probe_dyn_dma")
    _aligned("dyn_dma", t)
    out = torch.empty((1, W), dtype=torch.float32, device=t.device)
    _count("probe_dyn_dma", fn(idx.data_ptr(), t.data_ptr(), t.shape[0],
                               out.data_ptr(), _stream(t)))
    return out


def prefetch_plain(ids: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain version of `prefetch`."""
    return t.index_select(0, ids.long())


def prefetch(ids: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out [4, 128] = t[ids] for int32 ids [4] and float32 t [4096, 128],
    block i loading row ids[i] by TMA; a row outside [0, 4096) raises on
    the CPU and traps on the card."""
    _check("prefetch", (ids, I32, (PREFETCH_N,)), (t, F32, (V, W)))
    if not _on_cuda("prefetch", t):
        return prefetch_plain(ids, t)
    fn = _kernel("probe_prefetch")
    _aligned("prefetch", t)
    out = torch.empty((ids.shape[0], W), dtype=torch.float32, device=t.device)
    _count("probe_prefetch", fn(ids.data_ptr(), ids.shape[0], t.data_ptr(),
                                t.shape[0], out.data_ptr(), _stream(t)))
    return out


def loop_dma_plain(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain version of `loop_dma`: rows[0] + rows[1] + ..., in that
    order."""
    rows = t.index_select(0, idx.long())
    acc = rows[0]
    for j in range(1, rows.shape[0]):
        acc = acc + rows[j]
    return acc[None].clone()


def loop_dma(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out [1, 128] = t[idx[0]] + t[idx[1]] + ... + t[idx[7]] (in that
    order) for int32 idx [8] and float32 t [4096, 128], the 8 rows in
    flight together; a row outside [0, 4096) raises on the CPU and traps on
    the card."""
    _check("loop_dma", (idx, I32, (LOOP_N,)), (t, F32, (V, W)))
    if not _on_cuda("loop_dma", t):
        return loop_dma_plain(idx, t)
    fn = _kernel("probe_loop_dma")
    _aligned("loop_dma", t)
    out = torch.empty((1, W), dtype=torch.float32, device=t.device)
    _count("probe_loop_dma", fn(idx.data_ptr(), idx.shape[0], t.data_ptr(),
                                t.shape[0], out.data_ptr(), _stream(t)))
    return out


def blockspec_gather_plain(tof, cof, ids, hp, table):
    """Plain version of `blockspec_gather` (in place)."""
    local_rows = torch.arange(TILE, device=ids.device)[:, None]
    acc = torch.zeros(TILE, dtype=torch.float32, device=table.device)
    h = hp.reshape(-1)[0]
    tiles = tof.tolist()
    for t, c in zip(tiles, cof.tolist()):
        if t < 0 or (t + 1) * TILE > table.shape[0] or not 0 <= c < len(ids):
            raise IndexError(f"blockspec_gather: tile {t} or chunk {c} out "
                             "of range")
        counts = (local_rows == (ids[c].long() - t * TILE)).sum(1)
        acc = acc + counts.to(torch.float32) * h
    block = table[tiles[-1] * TILE:(tiles[-1] + 1) * TILE]
    block.copy_(block + acc[:, None])
    return table


def blockspec_gather(tof: torch.Tensor, cof: torch.Tensor, ids: torch.Tensor,
                     hp: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """In place on float32 table [32, 128], in 4 tiles of 8 rows: with acc
    = sum over the 2 steps g (in order) of count_g * hp[0, 0], where
    count_g[r] is how often row r of tile tof[g] (row tof[g]*8 + r) occurs
    in the id chunk ids[cof[g]], the rows of tile tof[1] become table +
    acc; every other row keeps its bits. int32 tof, cof [2], ids [2, 128];
    float32 hp [1, 1]. A tile or chunk out of range raises on the CPU and
    traps on the card. Returns table."""
    _check("blockspec_gather", (tof, I32, (STEPS,)), (cof, I32, (STEPS,)),
           (ids, I32, (STEPS, CHUNK)), (hp, F32, (1, 1)),
           (table, F32, (TILES * TILE, W)))
    if not _on_cuda("blockspec_gather", table):
        return blockspec_gather_plain(tof, cof, ids, hp, table)
    fn = _kernel("probe_blockspec_gather")
    _count("probe_blockspec_gather", fn(
        tof.data_ptr(), cof.data_ptr(), ids.data_ptr(), hp.data_ptr(),
        table.data_ptr(), _stream(table)))
    return table


# ------------------------------------------------------------------ inputs
def distinct_rows(rows: int) -> np.ndarray:
    """t[r, c] = r * 128 + c: every element distinct, exact in float32
    below 2^24 / 128 rows."""
    return np.arange(rows * W, dtype=np.float32).reshape(rows, W)


def rung_inputs(name: str, which: str = "jax") -> List[np.ndarray]:
    """The inputs of kernel rung `name`, in its call order: the JAX rung's
    own constants (``which="jax"``) or seeded inputs over distinct-row
    tables (``"distinct"``)."""
    if which not in ("jax", "distinct") or name not in KERNEL_RUNGS:
        raise ValueError(f"no input set {which!r} of a kernel rung {name!r}")
    jax = which == "jax"
    rng = np.random.default_rng(list(KERNEL_RUNGS).index(name))

    def table(fill):
        return np.full((V, W), fill, np.float32) if jax else distinct_rows(V)

    def rows(n, fixed):
        return (np.asarray(fixed) if jax else rng.integers(0, V, n)).astype(
            np.int32)

    if name == "vmem":
        return [np.ones((B, W), np.float32) if jax else distinct_rows(B)]
    if name in ("anyspace", "dma"):
        return [table(1.0 if name == "anyspace" else 3.0)]
    if name == "dyn_dma":
        return [rows(1, [7]), table(5.0)]
    if name == "prefetch":
        return [rows(PREFETCH_N, np.arange(PREFETCH_N)), table(7.0)]
    if name == "loop_dma":
        return [rows(LOOP_N, np.arange(LOOP_N)), table(1.0)]
    if name == "blockspec_gather":
        v = TILES * TILE
        if jax:
            # both steps hit tile 0; chunk g holds each of its rows 16 times
            return [np.zeros(STEPS, np.int32),
                    np.arange(STEPS, dtype=np.int32),
                    (np.arange(STEPS * CHUNK, dtype=np.int32)
                     .reshape(STEPS, CHUNK) % TILE),
                    np.full((1, 1), 2.0, np.float32),
                    np.zeros((v, W), np.float32)]
        # two different tiles, the chunks in reverse order, ids over all
        # four tiles, a scale whose products round
        return [np.asarray([1, 3], np.int32), np.asarray([1, 0], np.int32),
                rng.integers(0, v, (STEPS, CHUNK)).astype(np.int32),
                np.asarray([[rng.uniform(0.1, 1.0)]], np.float32),
                distinct_rows(v)]


# ---------------------------------------------------------------- holding
class LadderMismatch(AssertionError):
    """A rung's kernel disagrees with its plain version or its check."""


def _hold(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Bit-equal, else raise with the largest difference. Returns the max
    absolute error (0.0)."""
    if got.shape != want.shape or not torch.equal(got, want):
        err = ((got - want).abs().max().item() if got.shape == want.shape
               else float("inf"))
        raise LadderMismatch(f"{what}: kernel differs from its plain version "
                             f"(shapes {tuple(got.shape)} / "
                             f"{tuple(want.shape)}, max abs err {err})")
    return 0.0


def _expect(what: str, ok: bool) -> None:
    if not ok:
        raise LadderMismatch(what)


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


# rung -> (kernel, wrapper, plain version, out[0, 0] the JAX rung asserts)
KERNEL_RUNGS = {
    "vmem": ("probe_vmem", vmem, vmem_plain, 2.0),
    "anyspace": ("probe_anyspace", anyspace, anyspace_plain, 0.0),
    "dma": ("probe_dma", dma, dma_plain, 3.0),
    "dyn_dma": ("probe_dyn_dma", dyn_dma, dyn_dma_plain, 5.0),
    "prefetch": ("probe_prefetch", prefetch, prefetch_plain, 7.0),
    "loop_dma": ("probe_loop_dma", loop_dma, loop_dma_plain, float(LOOP_N)),
    "blockspec_gather": ("probe_blockspec_gather", blockspec_gather,
                         blockspec_gather_plain, 2 * (CHUNK // TILE) * 2.0),
}


def _kernel_rung(name: str, device: torch.device):
    """Rungs 1-7: the kernel against its plain version on both input sets
    (copies, so in-place rungs start alike) and the JAX rung's check on its
    own inputs. Returns (max abs err, a thunk that launches the kernel
    again on the JAX rung's inputs)."""
    _, fn, plain, first = KERNEL_RUNGS[name]
    path_args = _on(device, rung_inputs(name, "jax"))
    for which in ("jax", "distinct"):
        args = path_args if which == "jax" else _on(
            device, rung_inputs(name, which))
        got = fn(*[a.clone() for a in args])
        want = plain(*[a.clone() for a in args])
        _hold(f"{name} ({which} inputs)", got, want)
        if which == "jax":
            _expect(f"{name}: out[0, 0] = {got[0, 0].item()}, the TPU rung "
                    f"asserts {first}", got[0, 0].item() == first)
    return 0.0, functools.partial(fn, *path_args)


def rmw_scatter_inputs():
    """The TPU probe's `rung_rmw_scatter` inputs: table [4096, 128] zeros,
    256 sorted unique ids, normal deltas (`np.random.default_rng(0)`)."""
    rng = np.random.default_rng(0)
    v, w, n = 4096, 128, 256
    ids = np.sort(rng.choice(v, n, replace=False)).astype(np.int32)
    delta = rng.standard_normal((n, w)).astype(np.float32)
    return np.zeros((v, w), np.float32), ids, delta


def rung_rmw_scatter(device: torch.device):
    """Rung 8: ``table[ids] += delta`` by `sgd_rows` at lr -1, bit-equal to
    its plain version, within 1e-5 of ``index_add`` (the TPU rung's
    check)."""
    table, ids, delta = _on(device, rmw_scatter_inputs())
    got = cuda_sparse.sgd_rows(table.clone(), ids, delta, -1.0)
    want = cuda_sparse.sgd_rows_plain(table.clone(), ids, delta, -1.0)
    err = _hold("rmw_scatter", got, want)
    ref_err = (got - table.index_add(0, ids.long(), delta)).abs().max().item()
    _expect(f"rmw_scatter mismatch {ref_err}", ref_err < 1e-5)
    return err, functools.partial(cuda_sparse.sgd_rows, got, ids, delta, -1.0)


def tiled_inputs():
    """`_validate_tiled`'s inputs (``np.random.RandomState(0)``): ids
    [2048] over 4096 rows, deltas and table of width 16."""
    rng = np.random.RandomState(0)
    v, w, n = 4096, 16, 2048
    ids = rng.randint(0, v, n).astype(np.int32)
    delta = rng.randn(n, w).astype(np.float32)
    table = rng.randn(v, w).astype(np.float32)
    return ids, delta, table


def rung_tiled_kernels(device: torch.device):
    """Rung 9: `sgd_stream`, `adagrad_stream`, `gather_sorted` and
    `adam_stream` on one sorted stream of `_validate_tiled`'s inputs, each
    bit-equal to its plain version; sgd within 1e-3 of ``index_add`` and
    the unpermuted gather within 1e-4 of ``table[ids]`` (the TPU rung's
    checks)."""
    ids, delta, table = _on(device, tiled_inputs())
    v = table.shape[0]
    srt = canonical_id_sort(ids, v)
    starts, _ = segment_bounds(srt.seg_start)
    stream = (delta, srt.sid, srt.perm, starts)
    lr = 0.05

    got = cuda_tiled.sgd_stream(table.clone(), *stream, lr)
    err = _hold("tiled sgd", got,
                cuda_tiled.sgd_stream_plain(table.clone(), *stream, lr))
    ref = (got - table.index_add(0, ids.long(), delta, alpha=-lr)).abs().max()
    _expect(f"tiled sgd mismatch {ref.item()}", ref.item() < 1e-3)

    acc = torch.full_like(table, 0.1)
    got = cuda_tiled.adagrad_stream(table.clone(), acc.clone(), *stream, lr,
                                    1e-10)
    want = cuda_tiled.adagrad_stream_plain(table.clone(), acc.clone(),
                                           *stream, lr, 1e-10)
    err = max([err] + [_hold("tiled adagrad", a, b)
                       for a, b in zip(got, want)])

    rows = cuda_tiled.gather_sorted(table, srt.sid)
    err = max(err, _hold("tiled gather", rows,
                         cuda_tiled.gather_sorted_plain(table, srt.sid)))
    unsorted = torch.empty_like(rows)
    unsorted[srt.perm] = rows
    ref = (unsorted - table.index_select(0, ids.long())).abs().max()
    _expect(f"tiled gather mismatch {ref.item()}", ref.item() < 1e-4)

    zeros = [torch.zeros_like(table) for _ in range(2)]
    c1, c2 = cuda_sparse.bias_corrections(1, 0.9, 0.999)
    hyper = (0.01, 0.9, 0.999, 1e-8, c1, c2)
    got = cuda_tiled.adam_stream(table.clone(), *[z.clone() for z in zeros],
                                 *stream, *hyper)
    want = cuda_tiled.adam_stream_plain(table.clone(),
                                        *[z.clone() for z in zeros], *stream,
                                        *hyper)
    err = max([err] + [_hold("tiled adam", a, b) for a, b in zip(got, want)])

    work = [table.clone(), acc.clone(), *zeros]

    def again():
        cuda_tiled.sgd_stream(work[0], *stream, lr)
        cuda_tiled.adagrad_stream(work[0], work[1], *stream, lr, 1e-10)
        cuda_tiled.gather_sorted(work[0], srt.sid)
        cuda_tiled.adam_stream(work[0], work[2], work[3], *stream, *hyper)
    return err, again


class Rung(NamedTuple):
    """One rung: its name, the ``csrc/<library>.cu`` it builds, and
    ``run(device) -> (max abs err, launch thunk)``, which raises on any
    mismatch."""
    name: str
    library: str
    run: Callable[[torch.device], Tuple[float, Callable[[], object]]]


RUNGS: List[Rung] = [
    *(Rung(name, kernel, functools.partial(_kernel_rung, name))
      for name, (kernel, *_) in KERNEL_RUNGS.items()),
    Rung("rmw_scatter", "sparse_apply", rung_rmw_scatter),
    Rung("tiled_kernels", "sorted_stream", rung_tiled_kernels),
]


# ------------------------------------------------------------------ ladder
def _timed_build(library: str) -> Tuple[float, Optional[Exception]]:
    t0 = time.perf_counter()
    try:
        kernel_build.build([library])
    except (RuntimeError, OSError) as e:
        return time.perf_counter() - t0, e
    return time.perf_counter() - t0, None


def _usage(library: str) -> dict:
    """Most registers and static shared memory of any kernel of the
    library, and its spill bytes summed (one kernel for rungs 1-7)."""
    usage = kernel_build.ptxas_usage(library).values()
    return dict(registers=max((u["registers"] for u in usage), default=None),
                shared_bytes=max((u["shared_bytes"] for u in usage),
                                 default=None),
                spill_bytes=sum(u["spill_bytes"] for u in usage))


def run_ladder(device: DeviceLike = None,
               timer: Optional[Callable[[Callable[[], object]], float]] = None
               ) -> List[dict]:
    """Build every rung's source (on the card: one ``nvcc`` each, all at
    once; a source that fails to build fails its rung alone), then run
    every rung in `RUNGS` order, after a failure too. Returns one entry per
    rung: ``ok``, the head of the ``error``, ``build_s``, ``registers``,
    ``shared_bytes``, ``spill_bytes`` (on the card), ``max_abs_err``
    against the plain versions, and ``us`` = ``timer(launch)`` where a
    timer is given."""
    dev = resolve_device(device)
    rungs = list(RUNGS)
    on_card = dev.type == "cuda"
    built = {}
    if on_card:
        libraries = sorted({r.library for r in rungs})
        with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
            built = dict(zip(libraries, pool.map(_timed_build, libraries)))
    matrix = []
    for rung in rungs:
        entry = dict(rung=rung.name, library=rung.library, ok=False,
                     error=None, build_s=None, registers=None,
                     shared_bytes=None, spill_bytes=None, max_abs_err=None)
        try:
            if on_card:
                entry["build_s"], build_error = built[rung.library]
                if build_error is not None:
                    raise build_error
                entry.update(_usage(rung.library))
            err, launch = rung.run(dev)
            if on_card:
                torch.cuda.synchronize(dev)  # a fault shows in its rung
            entry["max_abs_err"] = err
            if timer is not None:
                entry["us"] = timer(launch)
            entry["ok"] = True
        except Exception as e:  # noqa: BLE001 - every rung runs and reports
            entry["error"] = f"{type(e).__name__}: {e}"[:400]
        matrix.append(entry)
    return matrix


def graph_us(launch: Callable[[], object], reps: int = 100,
             replays: int = 5) -> float:
    """Device microseconds per `launch()`: `reps` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * replays)


def _line(e: dict) -> str:
    if not e["ok"]:
        return f"FAIL {e['rung']}: {e['error']}"
    if e["build_s"] is None:
        return f"ok   {e['rung']:<17} (plain versions, {e['library']})"
    us = f"{e['us']:.2f} us" if e.get("us") is not None else "-"
    return (f"ok   {e['rung']:<17} build {e['build_s']:.1f} s  "
            f"registers {e['registers']}  smem {e['shared_bytes']} B  "
            f"spills {e['spill_bytes']} B  {us}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Build and run the Hopper feature ladder rung by rung.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    dev = resolve_device(parser.parse_args(argv).device)
    try:
        print(f"nvcc: {kernel_build.nvcc_version()}", flush=True)
    except (RuntimeError, OSError) as e:
        print(f"nvcc: none ({e})", flush=True)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    matrix = run_ladder(dev, timer=graph_us if dev.type == "cuda" else None)
    for e in matrix:
        print(_line(e), flush=True)
    print(json.dumps(matrix), flush=True)
    return 0 if all(e["ok"] for e in matrix) else 1


if __name__ == "__main__":
    sys.exit(main())
