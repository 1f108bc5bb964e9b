"""Device selection for the port's entry points: the card unless asked."""

from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``: in a process group of more than one rank,
    ``cuda:{rank % device_count}``, one card a rank (a caller whose ranks
    share a card passes `device`). A CUDA device on a host without one
    raises instead of quietly running on the CPU."""
    if device is None:
        device = "cuda"
        if (dist.is_initialized() and dist.get_world_size() > 1
                and torch.cuda.is_available()):
            device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; distributed_embeddings_tpu_torch "
            "runs on the card by default — pass device=\"cpu\" to run on the "
            "CPU")
    return dev


# the ROADMAP item that refuses a compute dtype other than float32
MIXED_PRECISION_ITEM = "A16 (mixed precision)"


def is_float32(dtype) -> bool:
    """True for None and for float32 however it is named: ``torch.float32``,
    ``"float32"``, ``np.float32`` or any type numpy reads as float32 (the
    JAX package's default, ``jnp.float32``, among them)."""
    if dtype is None or dtype is torch.float32:
        return True
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False


def check_compute_dtype(dtype, what: str) -> None:
    """Raise NotImplementedError naming the ROADMAP item unless `dtype` is
    float32 (or None): the port computes in float32 only."""
    if not is_float32(dtype):
        raise NotImplementedError(
            f"{what}(compute_dtype={dtype!r}): mixed precision is not ported "
            f"yet (ROADMAP Queue {MIXED_PRECISION_ITEM}); the port computes "
            "in float32")


def default_generator(device: torch.device,
                      generator: Optional[torch.Generator] = None,
                      seed: int = 0) -> torch.Generator:
    """The given generator, or a fresh one on `device` seeded with `seed`."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on `like`'s device. Dividing by it is a true
    division on CUDA too, where a Python-number divisor becomes a multiply
    by its reciprocal."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def settle_cpu_vector_math() -> None:
    """Make the process's first call into MKL's vector math library (behind
    torch's CPU ``sqrt``, ``exp``, ``log1p``, ...) on one thread. Its lazy
    set-up races when that first call runs on several intra-op threads at
    once: in about one process in ten, one thread's block of the result then
    comes from a low-accuracy kernel (``x`` times a 12-bit reciprocal square
    root estimate for ``sqrt``, about 3e-4 off). A one-element call, below
    the intra-op grain, settles the set-up on the calling thread."""
    torch.sqrt(torch.ones(1))
