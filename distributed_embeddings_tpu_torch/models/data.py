"""Datasets for the DLRM / Criteo examples.

Counterpart of ``distributed_embeddings_tpu/models/data.py`` (the
reference's data path, examples/dlrm/utils.py:116-307):
  * RawBinaryDataset: the split-binary Criteo-1TB layout (label.bin bool,
    numerical.bin float16, cat_{i}.bin in the smallest int dtype that fits
    each table), read by position with ``os.pread``.
  * DummyDataset: constant batches for benchmarking.

Batches are numpy on the host, as the JAX package returns them: the
ingest pipeline (`utils.pipeline`) stages them to the card. The JAX
package reads through its native prefetcher (``native/io.cpp``) when that
library loads and falls back to ``os.pread``; the port reads with
``os.pread`` until its own native library exists (ROADMAP Queue A9). The
bytes read, and so the batches, are the same.
"""

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
      prefetch_depth: batches the native prefetcher reads ahead; the
        ``os.pread`` reader reads on demand and ignores it.
      drop_last_batch: floor instead of ceil the batch count.
      valid: read test/ instead of train/.
      offset / local_batch_size: slice [offset:offset+lbs] out of each
        global batch for data-parallel inputs (labels not sliced in
        `valid` mode, ids only with `dp_input`).
      use_native_prefetch: accepted for the JAX package's signature; the
        port has no native reader yet (ROADMAP Queue A9) and reads with
        ``os.pread`` either way.
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
        del use_native_prefetch
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
        self._fds = [os.open(p, os.O_RDONLY) for p in self.paths]
        self.prefetch_depth = min(prefetch_depth, self._num_entries)

    def __len__(self):
        return self._num_entries

    def _read(self, file_idx: int, offset: int, size: int) -> np.ndarray:
        data = os.pread(self._fds[file_idx], size, offset)
        return np.frombuffer(data, np.uint8)

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
        I/O with no decoding. ``ds[idx]`` is ``preprocess(read_raw(idx))``."""
        if idx >= self._num_entries:
            raise IndexError
        bufs = [self._read(0, idx * self._label_bytes, self._label_bytes)]
        if self._num_file_idx is not None:
            bufs.append(self._read(self._num_file_idx, idx * self._num_bytes,
                                   self._num_bytes))
        for cat_id in self.categorical_features:
            nbytes = self._cat_bytes[cat_id]
            bufs.append(self._read(self._cat_file_idx[cat_id], idx * nbytes,
                                   nbytes))
        return bufs

    def raw_batches(self, steps: Optional[int] = None):
        """Generator over raw (undecoded) batches, wrapping indices: the
        `IngestPipeline` source, paired with ``preprocess``."""
        n = steps if steps is not None else self._num_entries
        for i in range(n):
            yield self.read_raw(i % self._num_entries)

    def __getitem__(self, idx: int):
        return self.preprocess(self.read_raw(idx))

    def close(self):
        """Close the files; idempotent."""
        fds, self._fds = self._fds, []
        for fd in fds:
            os.close(fd)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
