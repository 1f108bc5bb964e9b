"""Device selection for the port's entry points: the card unless asked."""

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device on a host without one raises
    instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; distributed_embeddings_tpu_torch "
            "runs on the card by default — pass device=\"cpu\" to run on the "
            "CPU")
    return dev


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
