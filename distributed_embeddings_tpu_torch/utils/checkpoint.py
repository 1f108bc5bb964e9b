"""Checkpoints: resume, the portable global weights, the stream container.

Counterpart of ``distributed_embeddings_tpu/utils/checkpoint.py``, in three
layers:

  * ``save_checkpoint`` / ``restore_checkpoint``: resume on the same
    topology. The JAX package writes an Orbax checkpoint of its placed
    pytree, each host its own shards; here each rank writes its own
    ``{params, opt_state}`` (a state dict and the train step's state:
    tensors, numbers and containers only) with ``torch.save`` to
    ``step_{N}/rank_{r}.pt``, with no gather, and rank 0 a ``meta.json``
    that names the tree's top-level keys (`checkpoint_keys`: a params-only
    save is told apart from ``{params, opt_state}`` without reading the
    tensors). Restoring loads with ``weights_only=True`` (what was saved
    from a card onto the template's device, what was saved from the host,
    an offloaded bucket's table and state, on the host) and copies into
    the template's tensors. These files
    are the port's own: the JAX package's Orbax cannot read them, nor can
    the port read Orbax's. A hot-sharded layer's state dict holds its hot
    shards (membership and rows, buffers) and the train step's state
    their optimizer state (``opt_state["emb"]["hot"]``), so a resume file
    carries them, as the JAX package's Orbax save carries
    ``params["hot"]``. The portable forms are the two below.
  * ``save_global_weights`` / ``load_global_weights``: one float32 array
    per original table, in original order (``np.savez``, or a directory
    of ``.npy`` files that `DistributedEmbedding.set_weights` memory-maps),
    produced by ``get_weights`` (decoded from a quantized bucket, the
    hot-resident rows written over their tables' rows) and
    consumed by ``set_weights`` (encoded into one); they survive topology
    and storage changes, and load in either package.
  * the stream container (``save_row_delta`` / ``load_row_delta`` /
    ``load_row_delta_meta``): named arrays and a JSON header in one
    uncompressed ``.npz``, version 2 with a crc32 per array and one over
    the header, payloads at f32, int8 or fp8 (``*_rows`` / ``table{i}``
    quantized, each with a ``*_scale`` float32 sibling). An fp8 payload is
    written as its bytes (``uint8``); a file the JAX package wrote holds it
    as raw 1-byte void. Both hash the same bytes, so files written by
    either package load, verified, in the other.

Not ported yet: the ``store.load`` fault hooks of the loaders (ROADMAP
Queue A15).
"""

import json
import os
import warnings
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.parallel import mesh as pg

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "checkpoint_keys",
    "latest_step",
    "save_global_weights",
    "load_global_weights",
    "save_row_delta",
    "load_row_delta",
    "load_row_delta_meta",
    "StreamIntegrityError",
    "verify_stream_payload",
    "legacy_load_count",
    "publish_atomic",
    "sweep_orphan_tmp",
    "STREAM_CONTAINER_VERSION",
    "STREAM_PAYLOAD_DTYPES",
]

# ---------------------------------------------------------------- container
# the payload dtypes a stream file can declare: `ops.wire.STORE_DTYPES`,
# pinned equal by the tests
STREAM_PAYLOAD_DTYPES = ("f32", "int8", "fp8")

# v2 adds a crc32 per array and one over the canonical header, both
# verified on load; v1 files (no checksums) load with one warning a process
STREAM_CONTAINER_VERSION = 2


def _check_payload_dtype(meta: dict, path: str) -> None:
    """Refuse a payload dtype this consumer does not decode: a ValueError
    (a configuration mismatch), never `StreamIntegrityError`, which is
    kept for damaged files."""
    dtype = meta.get("dtype", "f32")
    if dtype not in STREAM_PAYLOAD_DTYPES:
        raise ValueError(
            f"{path}: stream payload dtype {dtype!r} is not supported by "
            f"this consumer (supported: {STREAM_PAYLOAD_DTYPES}); upgrade "
            "the consumer or republish at a supported dtype")
    if dtype == "fp8":
        from distributed_embeddings_tpu_torch.ops.wire import fp8_supported
        if not fp8_supported():
            raise ValueError(
                f"{path}: stream payload is fp8 but this torch has no "
                "float8_e4m3fn; republish at int8/f32 or upgrade torch")


class StreamIntegrityError(ValueError):
    """A stream file's payload or header fails its checksum, or the file
    cannot be parsed: it is corrupt and must not be applied."""


_legacy_loads = 0
_legacy_warned = False


def legacy_load_count() -> int:
    """How many checksum-less (container v1) stream files this process
    loaded."""
    return _legacy_loads


def _note_legacy(path: str) -> None:
    global _legacy_loads, _legacy_warned
    _legacy_loads += 1
    if not _legacy_warned:
        _legacy_warned = True
        warnings.warn(
            f"{path}: checksum-less legacy stream file (container v1), "
            "loaded WITHOUT integrity verification. One warning per "
            "process; count via checkpoint.legacy_load_count().",
            RuntimeWarning, stacklevel=3)


def _array_crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _header_crc(meta: dict) -> int:
    clean = {k: meta[k] for k in meta if k != "header_crc"}
    return zlib.crc32(
        json.dumps(clean, sort_keys=True).encode()) & 0xFFFFFFFF


def verify_stream_payload(meta: dict, arrays: Dict[str, np.ndarray],
                          path: str = "<stream>") -> bool:
    """Check a loaded stream file against its checksums: True when
    verified, False for a v1 file (counted, warned once); raises
    `StreamIntegrityError` on a mismatch."""
    if "crc" not in meta:
        _note_legacy(path)
        return False
    if "header_crc" in meta and _header_crc(meta) != int(meta["header_crc"]):
        raise StreamIntegrityError(
            f"{path}: metadata header checksum mismatch")
    crc = meta["crc"]
    bad = [n for n in arrays
           if n not in crc or _array_crc(arrays[n]) != int(crc[n])]
    missing = [n for n in crc if n not in arrays]
    if bad or missing:
        raise StreamIntegrityError(
            f"{path}: payload checksum failure "
            f"(mismatched={bad}, missing={missing})")
    return True


# ------------------------------------------------------------- durability
def _fsync_fd_of(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def publish_atomic(tmp: str, final: str) -> str:
    """Publish `tmp` as `final` durably: fsync the file, rename it, then
    fsync the directory (best effort: some filesystems refuse it; the
    rename is atomic regardless)."""
    _fsync_fd_of(tmp)
    os.replace(tmp, final)
    try:
        _fsync_fd_of(os.path.dirname(os.path.abspath(final)) or ".")
    except OSError:
        pass
    return final


def sweep_orphan_tmp(directory: str) -> List[str]:
    """Remove the ``*.tmp*`` files a crashed publisher left in `directory`
    (no reader ever opens a tmp name). Returns the removed paths."""
    removed: List[str] = []
    if not os.path.isdir(directory):
        return removed
    for name in sorted(os.listdir(directory)):
        if ".tmp" in name:
            path = os.path.join(directory, name)
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                continue
    return removed


# ------------------------------------------------------------------ resume
_META = "meta.json"


def _step_dir(path: str, step: Optional[int]) -> str:
    return os.path.join(path, f"step_{step}") if step is not None else path


def _rank_file(target: str) -> str:
    return os.path.join(target, f"rank_{pg.rank()}.pt")


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    force: bool = False) -> str:
    """Save this rank's `state` (e.g. ``{"params": model.state_dict(),
    "opt_state": opt_state}``: tensors, numbers, strings and dicts, lists
    and tuples of them) under ``path/step_{step}`` (or `path`), as
    ``rank_{r}.pt``, with no gather; rank 0 also writes ``meta.json`` (the
    top-level keys and the world size). Every rank of a process group
    calls it. Refuses to overwrite an existing file unless `force`, as the
    JAX package's Orbax save does. Returns the directory written."""
    target = os.path.abspath(_step_dir(path, step))
    final = _rank_file(target)
    if os.path.exists(final) and not force:
        raise FileExistsError(
            f"checkpoint {final} exists; pass force=True to overwrite it")
    os.makedirs(target, exist_ok=True)
    torch.save(state, final + ".tmp")
    publish_atomic(final + ".tmp", final)
    if pg.rank() == 0:
        meta = {"keys": sorted(state) if isinstance(state, dict) else None,
                "world_size": pg.world_size(),
                "format": "torch.save, one file a rank"}
        with open(os.path.join(target, _META + ".tmp"), "w") as f:
            json.dump(meta, f)
        publish_atomic(os.path.join(target, _META + ".tmp"),
                       os.path.join(target, _META))
    return target


def _first_device(tree) -> Optional[torch.device]:
    if torch.is_tensor(tree):
        return tree.device
    values = (tree.values() if isinstance(tree, dict)
              else tree if isinstance(tree, (list, tuple)) else ())
    for v in values:
        dev = _first_device(v)
        if dev is not None:
            return dev
    return None


@torch.no_grad()
def _copy_into(template, loaded, where: str):
    """`template` with `loaded`'s values: each tensor copied into the
    template's own (shape and dtype must match), each dict key and list
    item of the template taken from `loaded`, numbers from `loaded`."""
    if torch.is_tensor(template):
        if not torch.is_tensor(loaded) or loaded.shape != template.shape \
                or loaded.dtype != template.dtype:
            got = (tuple(loaded.shape), loaded.dtype) \
                if torch.is_tensor(loaded) else type(loaded).__name__
            raise ValueError(f"checkpoint {where}: {got}, the template has "
                             f"{(tuple(template.shape), template.dtype)}")
        return template.copy_(loaded)
    if isinstance(template, dict):
        missing = [k for k in template if k not in loaded]
        if missing:
            raise KeyError(f"checkpoint {where}: no {missing}")
        return type(template)((k, _copy_into(v, loaded[k], f"{where}/{k}"))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        if len(loaded) != len(template):
            raise ValueError(f"checkpoint {where}: {len(loaded)} entries, "
                             f"the template has {len(template)}")
        return type(template)(_copy_into(v, w, f"{where}/{i}")
                              for i, (v, w) in enumerate(zip(template,
                                                             loaded)))
    return loaded


def restore_checkpoint(path: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """This rank's checkpoint, loaded with ``weights_only=True`` and
    copied into `template`'s tensors in place (e.g. ``{"params":
    model.state_dict(), "opt_state": init_fn(model)}``, which restores the
    model itself). Tensors saved from a card load onto the device of
    `template`'s first tensor; tensors saved from the host (an offloaded
    bucket's table and state among them) stay on the host until they are
    copied, so a restore neither stages tables on the card that it could
    not hold nor puts unpinned tensors in the place of pinned ones. The
    template may take a subset of the saved keys (``{"params": ...}`` of a
    full save). Returns the template's structure with the loaded values."""
    target = os.path.abspath(_step_dir(path, step))
    device = _first_device(template) or torch.device("cpu")

    def place(storage, location):
        if device.type == "cpu" or location.startswith("cpu"):
            return storage
        return storage.to(device=device)
    loaded = torch.load(_rank_file(target), map_location=place,
                        weights_only=True)
    return _copy_into(template, loaded, target)


def checkpoint_keys(path: str,
                    step: Optional[int] = None) -> Optional[List[str]]:
    """Top-level keys of a saved checkpoint tree, from its metadata (no
    tensor is read): tells a params-only save from ``{params,
    opt_state}``. None when the metadata cannot be read (callers must not
    take that for any particular format)."""
    try:
        with open(os.path.join(os.path.abspath(_step_dir(path, step)),
                               _META)) as f:
            keys = json.load(f)["keys"]
    except Exception:  # noqa: BLE001 - unreadable means unknown
        return None
    if not isinstance(keys, list) or not all(isinstance(k, str)
                                             for k in keys):
        return None
    return sorted(keys)


def latest_step(path: str) -> Optional[int]:
    """Largest step_{N} subdirectory under path, or None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return max(steps) if steps else None


# -------------------------------------------------------- global weights
def save_global_weights(path: str, weights: Sequence[np.ndarray],
                        npz: bool = True) -> str:
    """The portable embedding dump: `weights` (`get_weights`' one global
    ``[vocab, width]`` array per table, original order) as one ``.npz``
    (`npz`) or as ``table_{i}.npy`` files in the directory `path`."""
    if npz:
        np.savez(path, *[np.asarray(w) for w in weights])
        return path if path.endswith(".npz") else path + ".npz"
    os.makedirs(path, exist_ok=True)
    for i, w in enumerate(weights):
        np.save(os.path.join(path, f"table_{i}.npy"), np.asarray(w))
    return path


def load_global_weights(path: str, mmap: bool = True) -> List[np.ndarray]:
    """Load a global weights dump; the directory form memory-maps each
    table (with `mmap`), for `set_weights` of tables larger than memory."""
    mode = "r" if mmap else None
    if os.path.isdir(path):
        files = sorted((f for f in os.listdir(path)
                        if f.startswith("table_") and f.endswith(".npy")),
                       key=lambda f: int(f[6:-4]))
        return [np.load(os.path.join(path, f), mmap_mode=mode) for f in files]
    data = np.load(path)
    return [data[k] for k in sorted(data.files,
                                    key=lambda k: int(k.split("_")[1]))]


# ------------------------------------------------------------ row streams
def save_row_delta(path: str, meta: dict, arrays: Dict[str, np.ndarray]
                   ) -> str:
    """One stream file: the named numpy `arrays` and the JSON header `meta`
    in one uncompressed ``.npz`` (its byte count is the stream's bytes).
    The header gains ``dtype`` (``"f32"`` where the caller set none; int8
    and fp8 payloads carry a ``*_scale`` float32 sibling, an fp8 payload
    as its bytes), ``container`` (`STREAM_CONTAINER_VERSION`), ``crc`` (a
    crc32 per array over its raw bytes) and ``header_crc`` (the crc32 of
    the canonical header without itself). Returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = dict(meta)
    meta.setdefault("dtype", "f32")
    if meta["dtype"] not in STREAM_PAYLOAD_DTYPES:
        raise ValueError(
            f"save_row_delta: payload dtype {meta['dtype']!r} is not a "
            f"stream container dtype (expected one of "
            f"{STREAM_PAYLOAD_DTYPES})")
    meta["container"] = STREAM_CONTAINER_VERSION
    meta["crc"] = {name: _array_crc(arr) for name, arr in arrays.items()}
    meta["header_crc"] = _header_crc(meta)
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)
    return path


def load_row_delta(path: str, verify: bool = True
                   ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Read a stream file: (meta, {name: array}). With `verify`, the
    header's and every array's crc are checked (`StreamIntegrityError` on
    a mismatch; a v1 file loads with one warning). Damage the parse meets
    (bad zip structure, a member's zip crc, truncation, an unreadable
    header) is a `StreamIntegrityError` too; `OSError` passes through (a
    transient error a caller retries), and an unsupported payload dtype is
    a ValueError."""
    try:
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    except (OSError, StreamIntegrityError):
        raise
    except Exception as e:  # noqa: BLE001 - parse damage = corrupt file
        raise StreamIntegrityError(
            f"{path}: unreadable stream container "
            f"({type(e).__name__}: {e})") from e
    _check_payload_dtype(meta, path)
    if verify:
        verify_stream_payload(meta, arrays, path=path)
    return meta, arrays


def load_row_delta_meta(path: str, verify: bool = True) -> dict:
    """Read only a stream file's header (no payload is read), its own crc
    checked with `verify`; damage as in `load_row_delta`."""
    try:
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["__meta__"]))
    except (OSError, StreamIntegrityError):
        raise
    except Exception as e:  # noqa: BLE001 - parse damage = corrupt file
        raise StreamIntegrityError(
            f"{path}: unreadable stream header "
            f"({type(e).__name__}: {e})") from e
    if verify and "header_crc" in meta \
            and _header_crc(meta) != int(meta["header_crc"]):
        raise StreamIntegrityError(
            f"{path}: metadata header checksum mismatch")
    _check_payload_dtype(meta, path)
    return meta
