"""Initializer registry.

Counterpart of ``distributed_embeddings_tpu/utils/initializers.py``. An
initializer is a callable ``init(out, generator) -> out`` that fills the
tensor `out` in place, drawing from `generator` on `out`'s device — so a
4 GiB bucket is initialized where it lives, with no host staging and no
second copy. The registry names match the JAX package's.
"""

import math
from typing import Callable, Sequence, Union

import torch

InitializerSpec = Union[str, Callable]


def _uniform(scale: float):
    def init(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return out.uniform_(-scale, scale, generator=generator)
    return init


def _glorot_uniform(out, generator):
    limit = math.sqrt(6.0 / (out.shape[0] + out.shape[1]))
    return out.uniform_(-limit, limit, generator=generator)


def _zeros(out, generator):
    del generator
    return out.zero_()


def _ones(out, generator):
    del generator
    return out.fill_(1.0)


def _normal(out, generator):
    return out.normal_(0.0, 0.05, generator=generator)


_REGISTRY = {
    # keras 'uniform'/'random_uniform' default is +-0.05
    "uniform": _uniform(0.05),
    "random_uniform": _uniform(0.05),
    "glorot_uniform": _glorot_uniform,
    "zeros": _zeros,
    "ones": _ones,
    "normal": _normal,
    "random_normal": _normal,
}


def get_initializer(spec: InitializerSpec) -> Callable:
    """Resolve an initializer spec: a callable or a registry name."""
    if callable(spec):
        return spec
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise ValueError(f"Unknown initializer '{spec}'")
        return _REGISTRY[spec]
    if isinstance(spec, dict):
        raise NotImplementedError(
            "keras-serialized initializer dicts are not ported yet "
            "(ROADMAP Queue A4, remaining placement)")
    raise TypeError(f"Initializer spec must be str or callable, got "
                    f"{type(spec)}")


class ConcatInitializer:
    """Initialize a row-concatenated (fused) table as if each sub-table had
    been initialized on its own: rows ``[o_i, o_i + sizes[i])`` are filled
    by the inner initializer in order (shape-dependent initializers such as
    glorot see each sub-table's own shape)."""

    def __init__(self, initializer: InitializerSpec, sizes: Sequence[int]):
        self._initializer = get_initializer(initializer)
        self.sizes = list(sizes)

    def __call__(self, out: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        start = 0
        for size in self.sizes:
            self._initializer(out[start:start + size], generator)
            start += size
        return out
