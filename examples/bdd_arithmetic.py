"""Encrypted 4-bit addition via circuit bootstrapping + BDD evaluation
(mirror of poulpy-bin-fhe/examples/bdd_arithmetic.rs, scaled down).

Run on the CPU:  JAX_PLATFORMS=cpu python examples/bdd_arithmetic.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from poulpy_tpu.binfhe import bdd as bddm
from poulpy_tpu.binfhe.circuit_bootstrapping import circuit_bootstrapping_keygen
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.conversion import glwe_to_lwe_key_encrypt_sk
from poulpy_tpu.core.prepared import glwe_secret_prepare
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.source import Source


def main():
    base2k = 17
    module = Module(64, nprimes=4)
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    n_lwe = 16
    sk_lwe = src.binary_prob((n_lwe,))
    sk_glwe = enc.secret_new(module, 1, src)
    skp = glwe_secret_prepare(module, sk_glwe)

    cbt = circuit_bootstrapping_keygen(
        module, sk_lwe, sk_glwe, skp, base2k,
        k_brk=68, dnum_brk=4, k_atk=68, dnum_atk=4, k_tsk=68, dnum_tsk=4,
        source_xe=xe, source_xa=xa,
    )
    ks_lwe = glwe_to_lwe_key_encrypt_sk(
        module, jnp.asarray(sk_lwe), sk_glwe, base2k, 51, dnum=3,
        source_xe=xe, source_xa=xa,
    )
    key = bddm.BDDKey(
        cbt=cbt, ks_lwe=ks_lwe, n_lwe=n_lwe, base2k=base2k,
        k_ct=51, dnum_ggsw=3, k_ggsw=51,
    )

    width = 4
    va, vb = 9, 5
    ca = bddm.fheuint_encrypt(module, va, width, skp, base2k, 51, xe, xa)
    cb = bddm.fheuint_encrypt(module, vb, width, skp, base2k, 51, xe, xa)
    pa = bddm.fheuint_prepare(module, ca, key)
    pb = bddm.fheuint_prepare(module, cb, key)
    out = bddm.fheuint_op(module, "add", pa, pb, base2k, 51)
    got = bddm.fheuint_decrypt(module, bddm.FheUint(glwe=out, width=width), skp)
    print(f"{va} + {vb} mod 16 = {got}")
    assert got == (va + vb) % 16


if __name__ == "__main__":
    main()
