"""poulpy_tpu — a torus-FHE primitive library in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
`phantomzone-org/poulpy` (Rust, CPU): RLWE-based homomorphic encryption over
the torus using the bivariate base-2^-K limb representation
(eprint 2023/771), with

  * a kernel layer ("HAL" equivalent) of flat limb tensors, an exact
    negacyclic NTT over a CRT prime basis (one exact integer replacement
    for both of the reference's FFT64 / NTT120 DFT families), carry-propagation
    normalization, and prepared scalar-/vector-matrix products,
  * a backend-agnostic RLWE core (LWE/GLWE/GGLWE/GGSW encryption,
    key switching, external products, automorphisms, tensor products),
  * schemes on top: CGGI blind rotation / gate bootstrapping and a leveled
    CKKS evaluator with bit-shift rescaling,
  * batching as the throughput axis (every op is vmap-compatible), and
    `jax.sharding` meshes for multi-device scale-out.

Design mapping from the reference is documented in SURVEY.md §7; individual
docstrings cite the reference files (path:line under /root/reference) whose
behaviour they mirror.

The library requires 64-bit integer semantics (`jax_enable_x64`): limbs are
i64, exactly like the reference's `VecZnx` (poulpy-hal/src/layouts/vec_znx.rs:35).
"""

import jax

# i64 limb arithmetic everywhere (reference: VecZnx is i64; wrapping i64 is the
# defined "big coefficient" semantics of the FFT64 family backends).
jax.config.update("jax_enable_x64", True)

from poulpy_tpu.hal.module import Module  # noqa: E402,F401
from poulpy_tpu.hal.source import Source  # noqa: E402,F401

__version__ = "0.1.0"
