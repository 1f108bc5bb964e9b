"""ctypes wrapper for the native IntegerLookup hash map (hashmap.cpp).

Counterpart of ``distributed_embeddings_tpu/native/hashmap.py``.
"""

import threading

import numpy as np

from distributed_embeddings_tpu_torch.native import loader

__all__ = ["NativeIntegerLookup"]


class NativeIntegerLookup:
    """Host hash map: int64 keys -> contiguous indices (0 reserved for OOV).

    The backend of `layers.embedding.IntegerLookup`: the host replacement
    for the reference's cuCollections GPU map
    (embedding_lookup_kernels.cu:383-516). Every call into the map holds a
    per-map lock: ctypes releases the GIL during a native call, the map's
    probe threads assume no concurrent writer, and an ingest pipeline may
    call one layer from several threads (a fork while another thread is
    inside a lookup would also inherit a held mutex). Each translation or
    query adds one to ``loader.calls["integer_lookup"]``."""

    def __init__(self, capacity: int):
        self._lib = loader.load()
        self.capacity = int(capacity)
        self._handle = self._lib.il_create(self.capacity)
        self._call_lock = threading.Lock()

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.il_destroy(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    @property
    def size(self) -> int:
        # locked like the mutating calls: an ingest worker may be inside an
        # insert while another thread reads the size
        with self._call_lock:
            return int(self._lib.il_size(self._handle))

    def _translate(self, fn, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(keys.shape, dtype=np.int64)
        with self._call_lock:
            loader.count("integer_lookup")
            fn(self._handle, keys.ctypes.data, keys.size, out.ctypes.data)
        return out

    def lookup_or_insert(self, keys: np.ndarray) -> np.ndarray:
        """Each key's index, inserting unknown keys in first-appearance
        order (OOV 0 once the map is full); counts every occurrence."""
        return self._translate(self._lib.il_lookup_or_insert, keys)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Each key's index, 0 for an unknown key; inserts nothing."""
        return self._translate(self._lib.il_lookup, keys)

    def erase(self, keys: np.ndarray) -> np.ndarray:
        """Unbind keys: returns the freed index per key (0 = was not
        bound). Freed indices are reused by later lookup_or_insert calls
        (LIFO) before new indices are minted."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(keys.shape, dtype=np.int64)
        with self._call_lock:
            self._lib.il_erase(
                self._handle, keys.ctypes.data, keys.size, out.ctypes.data)
        return out

    def free_slots(self) -> np.ndarray:
        """Erased (reusable) indices, in reuse order."""
        with self._call_lock:
            n = int(self._lib.il_free_count(self._handle))
            out = np.empty((n,), dtype=np.int64)
            if n:
                self._lib.il_export_free(self._handle, out.ctypes.data)
        return out

    def keys_in_index_order(self):
        """Keys by index (index i + 1 at position i), up to the highest
        index ever assigned; erased indices hold INT64_MIN."""
        # one lock for the count and the export: an insert in between could
        # grow the reverse map mid-copy
        with self._call_lock:
            n = int(self._lib.il_high_water(self._handle))
            out = np.empty((n,), dtype=np.int64)
            if n:
                self._lib.il_export_keys(self._handle, out.ctypes.data)
        return out.tolist()

    def counts(self) -> np.ndarray:
        """Occurrences per index: [capacity] int64, index 0 = OOV."""
        out = np.zeros((self.capacity,), dtype=np.int64)
        with self._call_lock:
            self._lib.il_export_counts(self._handle, out.ctypes.data)
        return out
