"""Transparent dp-sharding of the core API over a Module-attached mesh.

SURVEY §2.8 frames the mesh as part of the *backend* ("`Module` ↔ (mesh,
N, twiddle/NTT constant arrays)"): attach a `jax.sharding.Mesh` to a
Module (`module_with_mesh`) and the public entry points — external
product, keyswitch, blind rotation, circuit bootstrap, CKKS mul — run
their batch axis sharded over the mesh's data-parallel axis with NO
call-site changes.  The reference has no distributed layer (its scale
story is a single process per machine); this is this library's design.

Mechanism: each wired entry point checks `module.mesh`; if set, it wraps
its own local computation in ONE `jax.shard_map` with every batch operand's
leading axis split over `module.batch_axis` and key material captured by
closure (replicated).  Inside the region the op re-enters itself with
`module.local` — the mesh-less twin — so nested ops never re-shard and
jit caches never mix the two worlds (the module IS the static cache key).

Pure dp needs no collectives; richer layouts (tp over the prime basis,
sp over the ring, kp over the blind-rotation key) remain available as the
explicit builders in parallel/sharded.py.
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P


def dp_shard(module, local_fn, *batch_trees):
    """Run `local_fn(*batch_trees)` under shard_map with the leading axis
    of every array leaf split over `module.batch_axis`; outputs are
    likewise batch-sharded.  Leading dims must divide the axis size."""
    in_specs = tuple(
        jax.tree.map(lambda _: P(module.batch_axis), t) for t in batch_trees
    )
    return jax.shard_map(
        local_fn,
        mesh=module.mesh,
        in_specs=in_specs,
        out_specs=P(module.batch_axis),
        check_vma=False,
    )(*batch_trees)


def shard_batch(module, tree, axis: int = 0):
    """Place array leaves with axis `axis` sharded over the module's
    batch axis (convenience for feeding dp-sharded entry points)."""
    mesh = module.mesh
    assert mesh is not None, "module has no mesh (use module_with_mesh)"

    def put(x):
        spec = [None] * x.ndim
        spec[axis] = module.batch_axis
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return jax.tree.map(put, tree)
