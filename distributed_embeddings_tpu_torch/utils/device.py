"""Device selection for the port's entry points: the card unless asked;
page-locked host memory for the tables that live on the host."""

import mmap
import time
import weakref
from typing import Optional, Sequence, Union

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


# the host's page: a pinned region starts and ends on one
HOST_PAGE = 4096


class HostPin:
    """A CPU tensor of `shape` and `dtype` in page-locked (pinned) host
    memory of exactly its size (rounded up to a page): an anonymous
    private mapping of its own, advised onto huge pages where the kernel
    offers them, zero-filled by torch's parallel fill (which faults its
    pages in on several threads, where the driver would on one), then
    registered with the CUDA driver (``cudaHostRegister``) and
    unregistered by `release` or when the pin is dropped. torch's caching
    host allocator (``pin_memory=True``) rounds a block up to a power of
    two, which at a table's size pins gigabytes more than the table. The
    tensor's storage starts at the mapping, so ``is_pinned()`` sees the
    registration; the tensor keeps the mapping alive, so its memory
    outlives the registration (after `release` it is ordinary host
    memory). ``seconds``: the host clock of mapping, filling and
    registering."""

    def __init__(self, shape: Sequence[int], dtype: torch.dtype):
        start = time.perf_counter()
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        span = -(-max(nbytes, 1) // HOST_PAGE) * HOST_PAGE
        region = mmap.mmap(-1, span, flags=mmap.MAP_PRIVATE)
        if hasattr(mmap, "MADV_HUGEPAGE"):
            try:
                region.madvise(mmap.MADV_HUGEPAGE)
            except OSError:
                pass
        flat = torch.frombuffer(region, dtype=torch.uint8)
        flat.zero_()
        err = torch.cuda.cudart().cudaHostRegister(flat.data_ptr(), span, 0)
        if int(err) != 0:
            raise RuntimeError(
                f"cudaHostRegister of {span} bytes failed ({err}): the host "
                "cannot page-lock the table")
        self.ptr, self.nbytes = flat.data_ptr(), span
        self.tensor = flat[:nbytes].view(dtype).view(tuple(shape))
        self.seconds = time.perf_counter() - start

    def release(self) -> None:
        """Unregister the mapping (its memory stays the tensor's)."""
        if self.ptr:
            ptr, self.ptr = self.ptr, 0
            torch.cuda.cudart().cudaHostUnregister(ptr)

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 - the driver may be gone at exit
            pass


def pinned_empty(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """An uninitialized `HostPin` tensor whose registration lasts as long
    as the returned tensor object: its memory is unregistered when that
    object is collected (a view kept longer holds ordinary host memory)."""
    pin = HostPin(shape, dtype)
    tensor, pin.tensor = pin.tensor, None
    weakref.finalize(tensor, pin.release)
    return tensor
