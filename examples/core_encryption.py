"""GLWE encrypt/decrypt roundtrip (mirror of
poulpy-cpu-ref/examples/core_encryption.rs, BASELINE config 1).

Run on the CPU:  JAX_PLATFORMS=cpu python examples/core_encryption.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from poulpy_tpu import Module, Source
from poulpy_tpu.core import decryption as dec
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.layouts import GLWEPlaintext
from poulpy_tpu.core.prepared import glwe_secret_prepare
from poulpy_tpu.hal import vec_znx


def main():
    n, base2k, k_ct, k_pt = 1024, 17, 51, 34
    module = Module(n, nprimes=2)
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]

    sk = enc.secret_new(module, rank=1, source=src)
    skp = glwe_secret_prepare(module, sk)

    data = np.random.default_rng(0).integers(-(2**15), 2**15, n, dtype=np.int64)
    pt = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, k_pt, 3, jnp.asarray(data)),
        base2k=base2k,
        k=k_pt,
    )
    ct = enc.glwe_encrypt_sk(module, pt, skp, base2k, k_ct, xe, xa)
    out = np.asarray(
        vec_znx.decode_vec_i64(base2k, k_pt, dec.glwe_decrypt(module, ct, skp).data)
    )
    print("max error:", np.abs(out - data).max())
    assert np.abs(out - data).max() <= 1


if __name__ == "__main__":
    main()
