"""Multi-device scale-out: device meshes, batch sharding, CRT-prime tensor
parallelism.

The reference has no distributed layer (SURVEY.md §2.8); this is new
design: ciphertext batches shard over a data-parallel mesh axis ("dp"), and
the CRT prime basis shards over a tensor-parallel axis ("tp") — each device
runs the NTT/VMP pipeline for its primes end-to-end and the centered CRT
lift all_gathers the residues once per inverse transform, so collectives
cross the device interconnect (NVLink within a host) exactly once per
keyswitch/external product.
"""

from poulpy_tpu.parallel.mesh import make_mesh  # noqa: F401
from poulpy_tpu.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    make_hybrid_mesh,
)
from poulpy_tpu.parallel.sharded import (  # noqa: F401
    shard_batch,
    sharded_external_product_fn,
    sharded_gate_bootstrap_fn,
)
