"""Per-rank input staging: the port's counterpart of ``parallel/staging.py``.

The JAX package's contract: each process loads only its own batch slice
and the staged arrays form the global batch, sharded over the mesh's one
axis. Here a rank's forward takes its slice itself, so `stage_dp_batch`
cuts a rank's contiguous slice ``[r * B_l, (r + 1) * B_l)`` out of a
global batch (as `InputGenerator` makes it) and moves it to the rank's
device. Rank r's slice is the r-th block of the global batch in both
packages, so the mp ranks see the samples in global order.
"""

from typing import Any

import numpy as np
import torch

from distributed_embeddings_tpu_torch.parallel import mesh
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           resolve_device)

__all__ = ["stage_dp_batch"]


def stage_dp_batch(batch: Any, *, device: DeviceLike = None) -> Any:
    """This rank's slice of a global batch, on its device.

    Args:
      batch: a pytree (tuples, lists, dicts) of numpy arrays or tensors,
        each [B, ...] with the global batch B on dim 0.
      device: where the slice goes (None: `resolve_device`'s default).

    Returns the same pytree of tensors [B / world, ...]. A global batch
    that does not divide by the world raises ValueError."""
    rank, world = mesh.rank(), mesh.world_size()
    dev = resolve_device(device)

    def stage(x):
        if isinstance(x, dict):
            return {k: stage(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(stage(v) for v in x)
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if t.shape[0] % world:
            raise ValueError(f"Global batch {t.shape[0]} not divisible by "
                             f"world size {world}")
        local = t.shape[0] // world
        return t[rank * local:(rank + 1) * local].to(dev)

    return stage(batch)
