"""Consistent-hash ring for the serving fleet.

Counterpart of ``distributed_embeddings_tpu/fleet/ring.py``, copied (it is
framework-free; the port imports nothing of the JAX package). Routing must
keep two properties the `serving.cache.HotRowCache` tier relies on:

  * **stability**: the same request key lands on the same replica while
    the membership holds, so each replica's cache sees a stable key subset
    and warms for it;
  * **bounded movement**: when a replica joins or leaves, only the keys of
    the affected hash ranges move (about 1/N of the traffic of an N-node
    fleet); a modulo router would remap N/(N+1) of all keys.

Each node is hashed onto a 64-bit ring at `vnodes` positions, and a key
routes to the first node position at or clockwise after its own hash.
Hashing is `blake2b` and process-independent (the builtin ``hash()`` is
salted per process), so the assignment survives restarts and equals the
JAX package's key for key.
"""

import hashlib
from typing import Dict, List, Optional

import numpy as np

__all__ = ["HashRing", "stable_hash64"]


def stable_hash64(key) -> int:
    """Deterministic 64-bit hash, identical across processes and runs:
    ints hash their 8-byte little-endian encoding, everything else its
    UTF-8 ``str()``."""
    if isinstance(key, (bool, float)):
        data = str(key).encode("utf-8")
    elif isinstance(key, (int, np.integer)):
        data = int(key).to_bytes(8, "little", signed=True)
    elif isinstance(key, bytes):
        data = key
    else:
        data = str(key).encode("utf-8")
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "little")


class HashRing:
    """Vnode consistent-hash ring: ``add`` / ``remove`` nodes, ``route``
    keys. A plain data structure; the `FleetRouter` owns the policy around
    it."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = max(int(vnodes), 1)
        self._points: Dict[int, str] = {}      # ring position -> node
        self._keys = np.empty(0, np.uint64)    # sorted positions
        self._owners: List[str] = []           # owner per position

    def _rebuild(self) -> None:
        items = sorted(self._points.items())
        self._keys = np.array([h for h, _ in items], np.uint64)
        self._owners = [n for _, n in items]

    def add(self, name: str) -> None:
        """Place `name` at its `vnodes` ring positions (idempotent)."""
        if name in self._owners:
            return
        for i in range(self.vnodes):
            h = stable_hash64(f"{name}#{i}")
            while h in self._points and self._points[h] != name:
                h = (h + 1) % (1 << 64)        # vanishing-odds collision
            self._points[h] = name
        self._rebuild()

    def remove(self, name: str) -> None:
        """Drop every position owned by `name` (idempotent). Keys in its
        ranges fall through to the next clockwise owner; nothing else
        moves."""
        if name not in self._owners:
            return
        self._points = {h: n for h, n in self._points.items() if n != name}
        self._rebuild()

    def nodes(self) -> List[str]:
        return sorted(set(self._owners))

    def __len__(self) -> int:
        return len(set(self._owners))

    def __contains__(self, name: str) -> bool:
        return name in self._owners

    def route(self, key) -> Optional[str]:
        """The node owning `key`'s ring position (None on an empty ring):
        the first position at or after the key's hash, wrapping."""
        if not self._owners:
            return None
        h = stable_hash64(key)
        idx = int(np.searchsorted(self._keys, np.uint64(h), side="left"))
        return self._owners[idx % len(self._owners)]

    def assignments(self, keys) -> Dict[object, Optional[str]]:
        """Route a batch of keys at once (the movement audits compare
        whole assignment maps before and after a membership change)."""
        return {k: self.route(k) for k in keys}
