"""Circuit bootstrapping: LWE(bit) → GGSW(bit), then GLWE × GGSW.

Mirrors /root/reference/poulpy-bin-fhe/examples/circuit_bootstrapping.rs:
encrypt one LWE bit under a block-binary secret, build the CBT key bundle
{brk, atk, tsk}, bootstrap the bit into a GGSW, and verify the GGSW acts as
the expected constant in an external product against a fresh GLWE.

Run on the CPU:  JAX_PLATFORMS=cpu python examples/circuit_bootstrapping.py
(on a GPU machine, drop JAX_PLATFORMS and it runs on the card)
"""

import os, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from poulpy_tpu.binfhe.circuit_bootstrapping import (
    circuit_bootstrap,
    circuit_bootstrapping_keygen,
)
from poulpy_tpu.core import decryption as dec, encryption as enc
from poulpy_tpu.core.external_product import glwe_external_product
from poulpy_tpu.core.layouts import GLWEPlaintext
from poulpy_tpu.core.prepared import ggsw_prepare, glwe_secret_prepare
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source


def main():
    # toy-sized for a quick CPU demo (the reference example runs
    # n_glwe=1024 / n_lwe=574 / block=7; same pipeline, larger ring)
    base2k = 17
    n_lwe, block = 16, 4
    log_domain = 3

    m = get_module(64, 4)
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)

    # LWE secret: block-binary (fill_binary_block in the reference) routes
    # the CBT blind rotation through the batched block path
    sk_lwe = src.binary_block(n_lwe, block)
    sk_glwe = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)

    t0 = time.perf_counter()
    cbt = circuit_bootstrapping_keygen(
        m, sk_lwe, sk_glwe, skp, base2k,
        k_brk=68, dnum_brk=4, k_atk=68, dnum_atk=4, k_tsk=68, dnum_tsk=4,
        source_xe=xe, source_xa=xa, block_size=block,
    )
    print(f"CBT-KGEN: {1e3 * (time.perf_counter() - t0):.0f} ms")

    # LWE(bit · 2^-(log_domain+1)) — positive half-circle encoding
    bit = 1
    pt = np.zeros((2, 1), dtype=np.int64)
    pt[0, 0] = bit << (base2k - 1 - log_domain)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, 34, xe, xa
    )

    t0 = time.perf_counter()
    # extension_factor=2 doubles the LUT domain (circuit.rs:288-299) — at
    # this toy N=64 ring the digit gap is too tight without it
    ggsw = circuit_bootstrap(
        m, lwe, log_domain, cbt, dnum_res=3, k_res=51, extension_factor=2
    )
    print(f"CBT: {1e3 * (time.perf_counter() - t0):.0f} ms")

    # GLWE(data) ⊡ GGSW(1) should round-trip data (identity action)
    data = np.random.default_rng(0).integers(
        -(2**12), 2**12, size=m.n, dtype=np.int64
    )
    pt_g = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 30, 2, jnp.asarray(data)),
        base2k=base2k, k=30,
    )
    ct = enc.glwe_encrypt_sk(m, pt_g, skp, base2k, 51, xe, xa)
    out = glwe_external_product(m, ct, ggsw_prepare(m, ggsw))
    got = np.asarray(vec_znx.decode_vec_i64(
        base2k, 30, dec.glwe_decrypt(m, out, skp).data
    ))
    err = np.abs(got - data).max()
    print(f"external-product round trip: max err {err} at scale 2^-30")
    assert err <= 1024
    print("pt_res[:8] =", got[:8], " expected", data[:8])


if __name__ == "__main__":
    main()
