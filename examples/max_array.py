"""Encrypted maximum of an array via BDD comparison + blind selection
(mirror of poulpy-bin-fhe/examples/max_array.rs, scaled down).

Per array element: circuit-bootstrap both candidates into GGSW bit
selectors, evaluate b = (input_i < max) with the Sltu BDD circuit,
bootstrap b, and blind-select the running maximum with a CMux
(max_array.rs:205-260 — sltu + GLWEBlindSelection over {0: input, 1: max}).

Run on the CPU:  JAX_PLATFORMS=cpu python examples/max_array.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp

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

    # BDD key bundle (bdd_arithmetic/key.rs:128-137): circuit-bootstrapping
    # keys + the GLWE→LWE switching key used to extract bits
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
    inputs = [9, 13, 5]
    cts = [
        bddm.fheuint_encrypt(module, v, width, skp, base2k, 51, xe, xa)
        for v in inputs
    ]

    # running maximum, starting from an encryption of 0
    max_ct = bddm.fheuint_encrypt(module, 0, width, skp, base2k, 51, xe, xa)
    for ct in cts:
        max_prep = bddm.fheuint_prepare(module, max_ct, key)
        ct_prep = bddm.fheuint_prepare(module, ct, key)
        # b = (input_i < max): 1 ⇒ keep max, 0 ⇒ take input_i
        cmp_glwe = bddm.fheuint_op(module, "sltu", ct_prep, max_prep, base2k, 51)
        cmp_prep = bddm.fheuint_prepare(
            module, bddm.FheUint(glwe=cmp_glwe, width=1), key
        )
        sel = bddm.blind_select(module, cmp_prep, [ct.glwe, max_ct.glwe])
        max_ct = bddm.FheUint(glwe=sel, width=width)

    got = bddm.fheuint_decrypt(module, max_ct, skp)
    print(f"max{inputs} = {got}")
    assert got == max(inputs)


if __name__ == "__main__":
    main()
