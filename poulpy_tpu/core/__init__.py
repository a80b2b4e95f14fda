"""Backend-agnostic RLWE core: LWE/GLWE/GGLWE/GGSW over the torus.

Functional JAX equivalent of poulpy-core: ciphertext layouts are pytree
dataclasses wrapping limb tensors, operations are pure functions over them,
and every operation vmaps over leading batch axes (the throughput axis
replacing the reference's one-ciphertext-at-a-time scalar loops).
"""

from poulpy_tpu.core.layouts import (  # noqa: F401
    GGLWE,
    GGSW,
    GLWE,
    LWE,
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    GLWEPlaintext,
    GLWESecret,
)
