"""Datasets for the DLRM / Criteo examples.

Counterpart of ``distributed_embeddings_tpu/models/data.py`` (the
reference's data path, examples/dlrm/utils.py:116-307):
  * RawBinaryDataset: the split-binary Criteo-1TB layout (label.bin bool,
    numerical.bin float16, cat_{i}.bin in the smallest int dtype that fits
    each table), read by position through the native prefetcher
    (``native/io.cpp``: a pool of threads issuing ``pread`` ahead of the
    consumer), or with ``os.pread`` when ``use_native_prefetch=False``.
  * DummyDataset: constant batches for benchmarking.

Batches are numpy on the host, as the JAX package returns them: the
ingest pipeline (`utils.pipeline`) stages them to the card. Both readers
give the same bytes, and so the same batches.
"""

import ctypes
import errno
import math
import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["get_categorical_feature_type", "DummyDataset",
           "RawBinaryDataset"]


def get_categorical_feature_type(size: int):
    """Smallest signed int dtype that holds `size` (reference
    utils.py:116-123)."""
    for np_type in (np.int8, np.int16, np.int32):
        if size < np.iinfo(np_type).max:
            return np_type
    raise RuntimeError(f"Categorical feature of size {size} is too big")


class DummyDataset:
    """Constant batches for benchmarking (reference utils.py:126-154)."""

    def __init__(self, batch_size: int, num_numerical_features: int,
                 table_sizes: Sequence[int], num_batches: int = 100,
                 hotness: Optional[Sequence[int]] = None):
        self.numerical = np.zeros((batch_size, num_numerical_features),
                                  np.float32)
        if hotness is None:
            self.categorical = [np.zeros((batch_size,), np.int32)
                                for _ in table_sizes]
        else:
            self.categorical = [np.zeros((batch_size, h), np.int32)
                                for h in hotness]
        self.labels = np.ones((batch_size, 1), np.float32)
        self.num_batches = num_batches

    def __len__(self):
        return self.num_batches

    def __getitem__(self, idx):
        if idx >= self.num_batches:
            raise IndexError
        return self.numerical, self.categorical, self.labels


class RawBinaryDataset:
    """Split-binary Criteo dataset.

    The read and decode halves are separate (`read_raw` / `preprocess`),
    so `utils.pipeline.IngestPipeline` can run them in their own worker
    threads; ``ds[idx]`` composes them inline.

    Args (the JAX package's):
      data_path: directory holding train/ or test/ with label.bin,
        numerical.bin, cat_{i}.bin.
      batch_size: samples per batch (global batch).
      numerical_features: how many dense features to load (0 = none).
      categorical_features: which table ids this process loads
        (model-parallel input loads only its own tables, reference
        utils.py:260-266).
      categorical_feature_sizes: vocab size per table (selects each file's
        dtype).
      prefetch_depth: batches the native prefetcher keeps in flight
        (1 or less: each read waits for itself); the ``os.pread`` reader
        reads on demand and ignores it.
      drop_last_batch: floor instead of ceil the batch count.
      valid: read test/ instead of train/.
      offset / local_batch_size: slice [offset:offset+lbs] out of each
        global batch for data-parallel inputs (labels not sliced in
        `valid` mode, ids only with `dp_input`).
      use_native_prefetch: read through the native prefetcher (its
        library is built at first use, and a failed build raises); False
        reads with ``os.pread``. Each read the prefetcher is given adds one
        to ``native.loader.calls["prefetch"]``. A file the prefetcher
        cannot open, a read that fails and a read cut short (a file
        truncated after the dataset was built) raise OSError.
    """

    def __init__(self,
                 data_path: str,
                 batch_size: int = 1,
                 numerical_features: int = 0,
                 categorical_features: Optional[Sequence[int]] = None,
                 categorical_feature_sizes: Optional[Sequence[int]] = None,
                 prefetch_depth: int = 10,
                 drop_last_batch: bool = False,
                 valid: bool = False,
                 offset: int = -1,
                 local_batch_size: int = -1,
                 dp_input: bool = False,
                 use_native_prefetch: bool = True):
        split = "test" if valid else "train"
        base = os.path.join(data_path, split)
        self.batch_size = batch_size
        self.numerical_features = numerical_features
        self.categorical_features = list(categorical_features or [])
        sizes = list(categorical_feature_sizes or [])
        self.cat_types = [get_categorical_feature_type(s) for s in sizes]
        self.offset = offset
        self.local_batch_size = local_batch_size
        self.valid = valid
        self.dp_input = dp_input

        self._label_bytes = np.dtype(np.bool_).itemsize * batch_size
        self._num_bytes = (numerical_features
                           * np.dtype(np.float16).itemsize * batch_size)
        self._cat_bytes = [np.dtype(t).itemsize * batch_size
                           for t in self.cat_types]

        self.paths = [os.path.join(base, "label.bin")]
        if numerical_features > 0:
            self.paths.append(os.path.join(base, "numerical.bin"))
        self._num_file_idx = 1 if numerical_features > 0 else None
        self._cat_file_idx = {}
        for cat_id in self.categorical_features:
            self._cat_file_idx[cat_id] = len(self.paths)
            self.paths.append(os.path.join(base, f"cat_{cat_id}.bin"))

        label_size = os.path.getsize(self.paths[0])
        rounder = math.floor if drop_last_batch else math.ceil
        self._num_entries = int(rounder(label_size / self._label_bytes))
        for path, nbytes in [(self.paths[0], self._label_bytes)] + (
                [(os.path.join(base, "numerical.bin"), self._num_bytes)]
                if numerical_features > 0 else []):
            n = int(rounder(os.path.getsize(path) / nbytes))
            if n != self._num_entries:
                raise ValueError(f"Size mismatch in {path}: expected "
                                 f"{self._num_entries}, got {n}")
        self._fds = []
        self._prefetcher = None
        self._pending = {}
        self.prefetch_depth = min(prefetch_depth, self._num_entries)
        if use_native_prefetch:
            from distributed_embeddings_tpu_torch.native import loader
            missing = [p for p in self.paths if not os.path.isfile(p)]
            if missing:
                raise FileNotFoundError(f"dataset files missing: {missing}")
            # a read is cut at the file's end, as os.pread cuts it
            self._sizes = [os.path.getsize(p) for p in self.paths]
            self._lib = loader.load()
            self._count = loader.count
            names = (ctypes.c_char_p * len(self.paths))(
                *[os.fsencode(p) for p in self.paths])
            err = (ctypes.c_int64 * 2)()
            self._prefetcher = self._lib.pf_create(names, len(self.paths), 4,
                                                   err)
            if not self._prefetcher:
                path = self.paths[err[0]]
                raise OSError(err[1], os.strerror(err[1]), path)
        else:
            self._fds = [os.open(p, os.O_RDONLY) for p in self.paths]

    def __len__(self):
        return self._num_entries

    def _read(self, file_idx: int, offset: int, size: int) -> np.ndarray:
        if self._prefetcher is None:
            data = os.pread(self._fds[file_idx], size, offset)
            return np.frombuffer(data, np.uint8)
        buf = self._buffer(file_idx, offset, size)
        self._count("prefetch")
        got = self._lib.pf_read(self._prefetcher, file_idx, offset, buf.size,
                                buf.ctypes.data)
        return self._checked(got, file_idx, offset, buf)

    def _checked(self, got: int, file_idx: int, offset: int,
                 buf: np.ndarray) -> np.ndarray:
        """`buf` if its read (`got`: bytes, or -errno) filled it, else
        OSError."""
        path = self.paths[file_idx]
        if got < 0:
            raise OSError(-got, os.strerror(-got), path)
        if got != buf.size:
            raise OSError(errno.EIO, f"read {got} of {buf.size} bytes at "
                          f"offset {offset}: the file shrank after the "
                          "dataset was built", path)
        return buf

    def _buffer(self, file_idx: int, offset: int, size: int) -> np.ndarray:
        return np.empty((max(0, min(size, self._sizes[file_idx] - offset)),),
                        np.uint8)

    def _batch_reads(self, idx: int):
        """(file, offset, size) of each read of batch `idx`."""
        reads = [(0, idx * self._label_bytes, self._label_bytes)]
        if self._num_file_idx is not None:
            reads.append((self._num_file_idx, idx * self._num_bytes,
                          self._num_bytes))
        for cat_id in self.categorical_features:
            nbytes = self._cat_bytes[cat_id]
            reads.append((self._cat_file_idx[cat_id], idx * nbytes, nbytes))
        return reads

    def _start_batch(self, idx: int) -> None:
        """Submit batch `idx`'s reads to the prefetcher; each buffer stays
        referenced in `_pending` until its read is waited for."""
        started = []
        for file_idx, offset, size in self._batch_reads(idx):
            buf = self._buffer(file_idx, offset, size)
            self._count("prefetch")
            req = self._lib.pf_submit(self._prefetcher, file_idx, offset,
                                      buf.size, buf.ctypes.data)
            started.append((req, file_idx, offset, buf))
        self._pending[idx] = started

    def _finish_batch(self, idx: int):
        """Batch `idx`'s buffers, once every read of it has ended (the
        buffers are written until then); OSError for a read that failed
        or came back short."""
        done = [(self._lib.pf_wait(self._prefetcher, req), file_idx, offset,
                 buf) for req, file_idx, offset, buf in self._pending.pop(idx)]
        return [self._checked(*d) for d in done]

    def _drain(self) -> None:
        """Wait for every read in flight (their buffers are written until
        then)."""
        for idx in list(self._pending):
            for req, *_ in self._pending.pop(idx):
                self._lib.pf_wait(self._prefetcher, req)

    def preprocess(self, bufs):
        """Decode raw byte buffers (from `read_raw`) into a batch
        ``(numerical [B, n] f32 or None, [cats [B] int32], labels [B, 1]
        f32)``: dtype views, the min-int -> int32 cast, the f16 -> f32
        numerical cast, the label reshape and the dp slicing, in whatever
        thread the caller runs it in (the ingest pipeline's preprocess
        worker)."""
        it = iter(bufs)
        labels = next(it).view(np.bool_).astype(np.float32)[:, None]
        numerical = None
        if self._num_file_idx is not None:
            numerical = next(it).view(np.float16).astype(np.float32).reshape(
                -1, self.numerical_features)
        cats = []
        for cat_id in self.categorical_features:
            cats.append(next(it).view(self.cat_types[cat_id])
                        .astype(np.int32))
        if self.offset >= 0:
            sl = slice(self.offset, self.offset + self.local_batch_size)
            if not self.valid:
                labels = labels[sl]
            if numerical is not None:
                numerical = numerical[sl]
            if self.dp_input:
                cats = [c[sl] for c in cats]
        return numerical, cats, labels

    def read_raw(self, idx: int):
        """Raw per-file byte buffers for batch `idx`, the read stage: pure
        I/O with no decoding. ``ds[idx]`` is ``preprocess(read_raw(idx))``.
        Through the native prefetcher, batches ``idx + 1 ..`` up to
        `prefetch_depth` in all are read ahead while the caller decodes
        this one; a batch outside that window restarts it there."""
        if idx >= self._num_entries:
            raise IndexError
        if self._prefetcher is None or self.prefetch_depth <= 1:
            return [self._read(*r) for r in self._batch_reads(idx)]
        if idx not in self._pending:
            self._drain()
            for i in range(idx, min(idx + self.prefetch_depth,
                                    self._num_entries)):
                self._start_batch(i)
        nxt = idx + self.prefetch_depth
        if nxt < self._num_entries and nxt not in self._pending:
            self._start_batch(nxt)
        return self._finish_batch(idx)

    def raw_batches(self, steps: Optional[int] = None):
        """Generator over raw (undecoded) batches, wrapping indices: the
        `IngestPipeline` source, paired with ``preprocess``."""
        n = steps if steps is not None else self._num_entries
        for i in range(n):
            yield self.read_raw(i % self._num_entries)

    def __getitem__(self, idx: int):
        return self.preprocess(self.read_raw(idx))

    def close(self):
        """Wait for the reads in flight and stop the prefetcher, or close
        the files; idempotent."""
        if self._prefetcher is not None:
            self._drain()
            prefetcher, self._prefetcher = self._prefetcher, None
            self._lib.pf_destroy(prefetcher)
        fds, self._fds = self._fds, []
        for fd in fds:
            os.close(fd)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
