"""Scheme-level benches the poulpy-bench suite measures as first-class
binaries but bench_full.py does not cover:

  - circuit bootstrapping throughput (poulpy-bench/benches/
    circuit_bootstrapping.rs config: N=1024, n_lwe=574, base2k=13,
    keys k=52/dnum 3, output GGSW k=26/dnum 2)
  - one FheUint u32 op, Add (poulpy-bench/benches/bdd_arithmetic.rs
    config: N=1024, n_lwe=679, block 7, base2k=15, keys k=60/dnum 4,
    GGSW k=45/dnum 3)

Prints one JSON line per metric, each with the device it ran on:
    python bench_schemes.py
Any failure raises and exits non-zero.
"""

import json
import time

import jax
import numpy as np

import jax.numpy as jnp

import poulpy_tpu  # noqa: F401  (enables 64-bit integers)
from poulpy_tpu.utils.compile_cache import enable_compile_cache
from poulpy_tpu.utils.device import describe


def bench_circuit_bootstrap(batch=32, iters=3, rank=1, block_size=1,
                            n_lwe=574):
    """Batched LWE-bit → GGSW circuit bootstraps per second.

    Mirrors the reference bench parameterization (circuit_bootstrapping.rs
    via bench_suite/schemes/circuit_bootstrapping.rs:47-81) except rank
    (reference uses rank 2; rank is a parameter here — pass rank=2 for the
    exact twin, rank=1 for the common deployment shape).  block_size > 1
    additionally measures the block-binary CGGI routing (the reference's
    own bdd_arithmetic config bootstraps through block 7 keys)."""
    from poulpy_tpu.binfhe.circuit_bootstrapping import (
        circuit_bootstrap,
        circuit_bootstrapping_keygen,
    )
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.prepared import glwe_secret_prepare
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, base2k = 1024, 13
    k_keys, dnum_keys = 52, 3
    k_res, dnum_res = 26, 2
    m = get_module(n, 2, 28)
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    if block_size > 1:
        sk_lwe = src.binary_block(n_lwe, block_size)
    else:
        sk_lwe = src.binary_prob((n_lwe,))
    sk_glwe = enc.secret_new(m, rank, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    key = circuit_bootstrapping_keygen(
        m, sk_lwe, sk_glwe, skp, base2k,
        k_brk=k_keys, dnum_brk=dnum_keys,
        k_atk=k_keys, dnum_atk=dnum_keys,
        k_tsk=k_keys, dnum_tsk=dnum_keys,
        source_xe=xe, source_xa=xa, block_size=block_size,
    )
    bits = np.arange(batch) % 2
    size = -(-13 // base2k)
    pt = np.zeros((batch, size, 1), dtype=np.int64)
    pt[:, 0, 0] = bits << (base2k - 2)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, 13, xe, xa
    )

    @jax.jit
    def step(data):
        return circuit_bootstrap(
            m, lwe.replace(data=data), 1, key, dnum_res, k_res
        ).data

    jax.block_until_ready(step(lwe.data))    # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(lwe.data)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return batch * iters / dt


def bench_u32_add(width=32, iters=3):
    """One FheUint<u32> Add through the BDD evaluator (2w→1w), mirroring
    bdd_arithmetic.rs's Add row at its exact parameterization."""
    from poulpy_tpu.binfhe import bdd as bddm
    from poulpy_tpu.binfhe.circuit_bootstrapping import (
        circuit_bootstrapping_keygen,
    )
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.conversion import glwe_to_lwe_key_encrypt_sk
    from poulpy_tpu.core.prepared import glwe_secret_prepare
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, n_lwe, block, base2k = 1024, 679, 7, 15
    k_ct, k_ggsw, dnum_ggsw = 2 * base2k, 3 * base2k, 3
    k_cbt, dnum_cbt = 4 * base2k, 4
    m = get_module(n, 2, 28)
    src = Source(bytes(32))
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    sk_lwe = src.binary_block(n_lwe, block)
    sk_glwe = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    cbt = circuit_bootstrapping_keygen(
        m, sk_lwe, sk_glwe, skp, base2k,
        k_brk=k_cbt, dnum_brk=dnum_cbt, k_atk=k_cbt, dnum_atk=dnum_cbt,
        k_tsk=k_cbt, dnum_tsk=dnum_cbt, source_xe=xe, source_xa=xa,
        block_size=block,
    )
    ks_lwe = glwe_to_lwe_key_encrypt_sk(
        m, jnp.asarray(sk_lwe), sk_glwe, base2k, k_ct, dnum=2,
        source_xe=xe, source_xa=xa,
    )
    key = bddm.BDDKey(
        cbt=cbt, ks_lwe=ks_lwe, n_lwe=n_lwe, base2k=base2k,
        k_ct=k_ct, dnum_ggsw=dnum_ggsw, k_ggsw=k_ggsw,
    )
    va, vb = 255, 30           # the reference bench inputs (:117-118)
    ca = bddm.fheuint_encrypt(m, va, width, skp, base2k, k_ct, xe, xa)
    cb = bddm.fheuint_encrypt(m, vb, width, skp, base2k, k_ct, xe, xa)
    t0 = time.perf_counter()
    pa = bddm.fheuint_prepare(m, ca, key)
    pb = bddm.fheuint_prepare(m, cb, key)
    jax.block_until_ready(pb.bits[0].pmat)
    prep_s = (time.perf_counter() - t0) / 2

    @jax.jit
    def add_op(pa_, pb_):
        return bddm.fheuint_op(m, "add", pa_, pb_, base2k, k_ct)

    jax.block_until_ready(add_op(pa, pb).data)   # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = add_op(pa, pb)
    jax.block_until_ready(out.data)
    dt = time.perf_counter() - t0
    return iters / dt, prep_s


def main():
    enable_compile_cache()

    def emit(metric, value, unit, **extra):
        print(json.dumps({
            "metric": metric, "value": value, "unit": unit,
            "vs_baseline": None, **extra, **describe(),
        }), flush=True)

    emit("circuit_bootstraps_per_s_n1024", bench_circuit_bootstrap(),
         "cbt/s", config="ref circuit_bootstrapping.rs (rank 1)")
    emit("circuit_bootstraps_block8_per_s_n1024",
         bench_circuit_bootstrap(block_size=8, n_lwe=576), "cbt/s",
         config="block-binary routing (the bdd_arithmetic.rs CBT shape)")
    add, prep = bench_u32_add()
    emit("fheuint_u32_add_per_s_n1024", add, "ops/s",
         config="ref bdd_arithmetic.rs Add")
    emit("fheuint_u32_prepare_s_n1024", prep, "s",
         note="32 circuit bootstraps + GGSW preparation per operand "
              "(single dispatch, includes compile-adjacent overheads)")


if __name__ == "__main__":
    main()
