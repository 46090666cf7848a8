"""Pytree base class for sparse-format containers.

Design notes:
  * Every format is a pytree of *statically shaped* ``jnp`` arrays so it can
    flow through ``jit`` / ``shard_map`` / ``scan`` without retracing on nnz
    changes.  The number of stored entries is padded up to a static
    ``nnz capacity``; padding entries are constructed to be *harmless under
    accumulation* (zero value, in-range index).  This generalizes the
    reference's sentinel-zero trick (reference src/sparse/sparse-matrix.cc:29-31,
    where ``val_table[size] = 0`` makes filler entries contribute nothing).
  * Logical metadata (shape, nnz, block sizes, dtypes) lives in the pytree
    *aux data* so it stays Python-static under tracing.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SparseFormat", "register_sparse_pytree", "pad_to", "default_index_dtype"]

default_index_dtype = jnp.int32


def pad_to(arr, capacity: int, fill, axis: int = 0):
    """Pad ``arr`` along ``axis`` to length ``capacity`` with ``fill``."""
    arr = jnp.asarray(arr)
    cur = arr.shape[axis]
    if cur > capacity:
        raise ValueError(f"array length {cur} exceeds capacity {capacity}")
    if cur == capacity:
        return arr
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, capacity - cur)
    return jnp.pad(arr, pad_width, constant_values=fill)


def register_sparse_pytree(cls):
    """Register a dataclass as a pytree.

    Fields whose metadata contains ``static=True`` become aux data; all other
    fields are children (arrays).
    """
    fields = dataclasses.fields(cls)
    data_names = tuple(f.name for f in fields if not f.metadata.get("static", False))
    static_names = tuple(f.name for f in fields if f.metadata.get("static", False))

    def flatten_with_keys(obj):
        children = tuple(
            (jax.tree_util.GetAttrKey(n), getattr(obj, n)) for n in data_names
        )
        aux = tuple(getattr(obj, n) for n in static_names)
        return children, aux

    def flatten(obj):
        return tuple(getattr(obj, n) for n in data_names), tuple(
            getattr(obj, n) for n in static_names
        )

    def unflatten(aux, children):
        kwargs = dict(zip(data_names, children))
        kwargs.update(zip(static_names, aux))
        return cls(**kwargs)

    jax.tree_util.register_pytree_with_keys(cls, flatten_with_keys, unflatten, flatten)
    cls._data_fields = data_names
    cls._static_fields = static_names
    return cls


class SparseFormat:
    """Mixin with common sparse-container behavior.

    Subclasses are dataclasses with array fields (pytree children) and
    static fields (aux).  All provide:
      * ``shape`` — logical (rows, cols)
      * ``nnz`` — logical number of stored entries (static int)
      * ``todense()`` — decode to a dense ``jnp`` array (the ``CopyTo``
        analogue, reference src/sparse/sparse-matrix.cc:102-137)
    """

    _data_fields: ClassVar[Tuple[str, ...]]
    _static_fields: ClassVar[Tuple[str, ...]]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def ndim(self) -> int:
        return 2

    def todense(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype):
        return dataclasses.replace(self, data=self.data.astype(dtype))

    def block_until_ready(self):
        for leaf in jax.tree_util.tree_leaves(self):
            leaf.block_until_ready()
        return self

    # ------------------------------------------------------------------
    # Equality mirrors the reference's operator==
    # (reference src/sparse/sparse-matrix.cc:198-207): same logical
    # matrix, compared via densified values.
    # ------------------------------------------------------------------
    def allclose(self, other, rtol=0.0, atol=0.0) -> bool:
        if self.shape != other.shape:
            return False
        a = np.asarray(self.todense())
        b = np.asarray(other.todense())
        return np.allclose(a, b, rtol=rtol, atol=atol)

    def __repr__(self):
        statics = {n: getattr(self, n) for n in self._static_fields}
        return f"{type(self).__name__}({statics})"
