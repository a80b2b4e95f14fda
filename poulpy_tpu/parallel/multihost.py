"""Multi-host initialization and hybrid network × NVLink meshes.

The reference is a single-process CPU library (SURVEY.md §2.8); scaling
across hosts is new territory here.  The design follows the standard JAX
multi-controller recipe:

* every host runs the SAME program; `jax.distributed.initialize()` wires
  the controllers together (coordinator address, process count and process
  id are passed explicitly);
* after init, `jax.devices()` is the GLOBAL device list and mesh axes may
  span hosts.  Axes that cross host boundaries ride the network between
  hosts; axes within a host ride NVLink (all-to-all between the GPUs of
  one host) — so the mesh must be built host-outer / device-inner.

Axis placement for the poulpy workloads:

* `dp` (ciphertext batch) — the embarrassingly-parallel axis: zero
  collectives, so it is the ONLY axis that should span hosts.  Gate
  bootstrapping / external-product batches scale linearly with hosts.
* `tp` (CRT primes) — one all_gather per inverse transform: keep within a
  host.
* `sp` (ring degree N) — all_to_all per NTT stage: strictly within a host.

`make_hybrid_mesh` encodes exactly that: dp = (n_hosts × leftover devices),
tp/sp inner, devices-within-host minor so collectives over tp/sp never
leave the host.
"""

from __future__ import annotations

import jax
import numpy as np


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
) -> None:
    """Wire up the multi-controller runtime (idempotent).

    Pass all three arguments for a multi-host run; with none, a failed
    initialization degrades to single-process with a warning (dev/test
    mode).  Must run before any other jax call on every host.
    """
    # idempotence check WITHOUT touching the backend: jax.process_count()
    # would initialize XLA and make a subsequent distributed.initialize
    # fail ("must be called before any JAX calls") — the public
    # is_initialized() probes the distributed client without doing so
    # (regression: tests/test_multihost.py)
    if jax.distributed.is_initialized():
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    if initialization_timeout is not None:
        kwargs.update(initialization_timeout=initialization_timeout)
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        if coordinator_address is not None:
            # the caller explicitly asked for a pod: degrading to a single
            # host silently would run the workload at 1/n_hosts scale and
            # mask the misconfiguration — fail loud
            raise
        import warnings

        warnings.warn(
            "jax.distributed.initialize() failed with no explicit "
            "coordinator; continuing single-process (dev/test mode)",
            RuntimeWarning,
            stacklevel=2,
        )


def make_hybrid_mesh(tp: int = 1, sp: int = 1):
    """(dp, tp, sp) mesh over all global devices, host-aware.

    tp·sp must divide the per-host device count so those axes stay within a
    host; dp absorbs everything else (hosts × leftover devices).  Single-host (and
    the CPU virtual-device test mesh) degenerates to a plain mesh with the
    same axis layout.
    """
    devs = jax.devices()
    n_local = len([d for d in devs if d.process_index == devs[0].process_index])
    n_hosts = max(1, len(devs) // max(n_local, 1))
    inner = tp * sp
    if n_local % inner != 0:
        raise ValueError(
            f"tp*sp={inner} must divide per-host device count {n_local} "
            "(tp/sp collectives must stay within a host)"
        )
    if n_hosts > 1:
        from jax.experimental import mesh_utils

        # host axis outer-most → only dp crosses hosts; granule = process
        # (host), the multi-host single-slice grouping — the default
        # slice_index granule is for multi-SLICE deployments
        arr = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(n_local // inner, tp, sp),
            dcn_mesh_shape=(n_hosts, 1, 1),
            devices=devs,
            process_is_granule=True,
        )
    else:
        arr = np.asarray(devs).reshape(len(devs) // inner, tp, sp)
    return jax.sharding.Mesh(arr, ("dp", "tp", "sp"))
