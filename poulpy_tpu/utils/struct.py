"""Frozen-dataclass pytrees for the layout classes.

`@dataclass` turns a class into a frozen dataclass registered with
`jax.tree_util.register_dataclass`: fields are pytree leaves (arrays that
cross `jit`, `vmap` and `device_put`) unless declared with
`field(pytree_node=False)`, in which case they are static metadata carried
in the treedef (hashed into jit cache keys, so they must be hashable).
`.replace(**changes)` returns a copy with the given fields swapped.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """`dataclasses.field` with a `pytree_node` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration + `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
