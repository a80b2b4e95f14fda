"""Oblivious database lookup from a STREAM of ciphertexts.

Mirror of the reference's GLWEBlindRetriever usage
(poulpy-bin-fhe/src/bdd_arithmetic/blind_retrieval.rs): a server streams
rows past the accumulator one at a time; only ceil(log2 n)+1 GLWEs are
ever live, and the flushed result encrypts row[idx] for the client's
encrypted index — the server never learns which row was taken.

Run on the CPU:
  JAX_PLATFORMS=cpu python examples/blind_retrieval.py
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from poulpy_tpu.binfhe import bdd as bddm
from poulpy_tpu.binfhe.blind_retrieval import GLWEBlindRetriever
from poulpy_tpu.core import decryption as dec
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.layouts import GLWEPlaintext
from poulpy_tpu.core.prepared import ggsw_prepare, glwe_secret_prepare
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.source import Source


def main():
    base2k, k_ct, k_sel, pt_k = 17, 51, 68, 30
    m = Module(64, nprimes=4)
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, src))

    n_rows, idx = 16, 11
    rng = np.random.default_rng(0)
    rows = [rng.integers(-(2**12), 2**12, m.n).astype(np.int64)
            for _ in range(n_rows)]

    # client: encrypt the index bits as GGSW selectors
    bits = []
    for i in range(4):
        b = (idx >> i) & 1
        pt = jnp.zeros((m.n,), jnp.int64).at[0].set(b)
        g = enc.ggsw_encrypt_sk(m, pt, skp, base2k, k_sel, dnum=3,
                                source_xe=xe, source_xa=xa)
        bits.append(ggsw_prepare(m, g))
    sel = bddm.FheUintPrepared(bits=bits, width=4)

    # server: stream the encrypted rows through the retriever
    ret = GLWEBlindRetriever(n_rows)
    for r, row in enumerate(rows):
        pt = GLWEPlaintext(
            data=vec_znx.encode_vec_i64(base2k, pt_k, 2, jnp.asarray(row)),
            base2k=base2k, k=pt_k,
        )
        ct = enc.glwe_encrypt_sk(m, pt, skp, base2k, k_ct, xe, xa)
        ret.add(m, ct, sel)
        live = sum(s[1] for s in ret._slots)
        print(f"streamed row {r:2d}  live accumulator slots: {live}")
    out = ret.flush(m, sel)

    got = np.asarray(vec_znx.decode_vec_i64(
        base2k, pt_k, dec.glwe_decrypt(m, out, skp).data))
    err = np.abs(got - rows[idx]).max()
    print(f"retrieved row {idx}: max err {err} (noise) — "
          f"{'OK' if err <= 64 else 'FAIL'}")
    assert err <= 64


if __name__ == "__main__":
    main()
