"""Binary / gate-level FHE (poulpy-bin-fhe): CGGI blind rotation, gate
bootstrapping, circuit bootstrapping, BDD arithmetic on packed integers.

Batched structure: the blind-rotation loop over LWE coefficients is a
`lax.scan` over a stacked GGSW key tensor, and whole batches of ciphertexts
ride the leading axes through one compiled scan — the throughput shape for
the BASELINE gate-bootstraps/s metric.
"""

from poulpy_tpu.binfhe.lut import LookupTable  # noqa: F401
from poulpy_tpu.binfhe.blind_rotation import (  # noqa: F401
    BlindRotationKeyPrepared,
    blind_rotation_execute,
    blind_rotation_key_encrypt_sk,
)
from poulpy_tpu.binfhe.blind_retrieval import (  # noqa: F401
    GLWEBlindRetriever,
    glwe_blind_retrieval,
    glwe_blind_retrieval_rev,
    glwe_blind_selection,
    glwe_cswap,
)
