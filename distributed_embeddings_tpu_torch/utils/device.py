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


# the compute dtypes by name: float32 is no mixed precision (None)
_COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def _dtype_name(dtype) -> Optional[str]:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str):
        return dtype
    try:
        # numpy types and dtypes; ml_dtypes' bfloat16 (``jnp.bfloat16``)
        # is one once its caller has imported it
        return np.dtype(dtype).name
    except TypeError:
        return getattr(dtype, "__name__", None)


def resolve_compute_dtype(dtype, what: str = "compute_dtype"
                          ) -> Optional[torch.dtype]:
    """The mixed-precision compute dtype of the JAX package's
    ``compute_dtype`` argument: None for None or float32, ``torch.bfloat16``
    or ``torch.float16`` for those. Takes the dtype under any name its
    callers use: a torch dtype, a string (``"bfloat16"``), a numpy type or
    dtype, ``jnp.bfloat16``. Raises ValueError for any other dtype."""
    if dtype is None:
        return None
    name = _dtype_name(dtype)
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"{what}={dtype!r}: the compute dtype is float32, "
                         "bfloat16 or float16")
    return _COMPUTE_DTYPES[name]


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
