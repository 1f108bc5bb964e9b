"""Initializer registry.

Counterpart of ``distributed_embeddings_tpu/utils/initializers.py``. An
initializer is a callable ``init(out, generator) -> out`` that fills the
tensor `out` in place, drawing from `generator` on `out`'s device — so a
4 GiB bucket is initialized where it lives, with no host staging and no
second copy. The registry names match the JAX package's, and so do the
keras-serialized ``{"class_name", "config"}`` dicts it takes (the form
keras ``get_config()`` emits, which the reference's planner IR carries
through slicing and concatenation). A quantized bucket fills its tables in
row chunks; each chunk carries its table's shape as ``table_shape``, which
the shape-dependent initializers read (`table_shape`).
"""

import math
from typing import Callable, Sequence, Union

import torch

InitializerSpec = Union[str, Callable, dict]


def _uniform(scale: float):
    def init(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return out.uniform_(-scale, scale, generator=generator)
    return init


def table_shape(out: torch.Tensor):
    """The shape of the table `out` belongs to: its own, or, for a row
    chunk of a larger table, the ``table_shape`` the chunk carries."""
    return getattr(out, "table_shape", tuple(out.shape))


def _glorot_uniform(out, generator):
    rows, width = table_shape(out)
    limit = math.sqrt(6.0 / (rows + width))
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


def _from_keras_config(class_name: str, config: dict) -> Callable:
    """The initializer of a keras-serialized dict's class and config (the
    JAX package's `_from_keras_config`, with its defaults)."""
    name = class_name.lower()
    if name in ("randomuniform", "random_uniform", "uniform"):
        lo, hi = config.get("minval", -0.05), config.get("maxval", 0.05)

        def init(out, generator):
            return out.uniform_(lo, hi, generator=generator)
        return init
    if name in ("randomnormal", "random_normal", "truncatednormal",
                "truncated_normal", "normal"):
        mean, stddev = config.get("mean", 0.0), config.get("stddev", 0.05)

        def init(out, generator):
            if "truncated" in name:
                torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                            generator=generator)
            else:
                out.normal_(0.0, 1.0, generator=generator)
            return out.mul_(stddev).add_(mean)
        return init
    if name in ("zeros", "ones", "glorot_uniform", "glorotuniform"):
        return _REGISTRY["glorot_uniform" if "glorot" in name else name]
    if name == "constant":
        value = config.get("value", 0.0)

        def init(out, generator):
            del generator
            return out.fill_(value)
        return init
    raise ValueError(f"Unknown keras initializer class '{class_name}'")


def get_initializer(spec: InitializerSpec) -> Callable:
    """Resolve an initializer spec: a callable, a registry name, or a
    keras-serialized ``{"class_name", "config"}`` dict."""
    if callable(spec):
        return spec
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise ValueError(f"Unknown initializer '{spec}'")
        return _REGISTRY[spec]
    if isinstance(spec, dict) and "class_name" in spec:
        return _from_keras_config(spec["class_name"],
                                  spec.get("config") or {})
    raise TypeError(f"Initializer spec must be str, keras config dict or "
                    f"callable, got {type(spec)}")


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
