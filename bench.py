"""Headline benchmark: batched GLWE external products per second on one
device.

Runs on jax.devices()[0] and prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, <device fields>}

Configuration mirrors BASELINE.json config 3 territory: N=2048, base2k=17,
ct k=51 (3 limbs), GGSW k=68 (dnum 3, rank 1, dsize 1) — the CGGI blind
rotation inner loop.  Throughput comes from the batch axis: one jitted
pipeline evaluates B external products at once.

After the timed loop the same jitted step runs on a 64-ciphertext slice on
the device and on the in-process CPU backend: the results must be
bit-identical (integer arithmetic only), and the device result must decrypt
to X·m.  A failure exits non-zero before the JSON line.  `--verify` runs
only that check.

`vs_baseline`: the reference publishes no numbers (BASELINE.md); the
denominator is poulpy_tpu/native/baseline_bench.cpp — a single-thread C++
twin of the reference FFT64/AVX external product (four-step reim FFT,
exact-oracle gated) — measured once on the host named in
CPU_BASELINE_HOST, not on the machine that runs this script.
"""

import json
import os
import sys
import time

import jax
import numpy as np

import jax.numpy as jnp

from poulpy_tpu.core import decryption as dec
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.external_product import glwe_external_product
from poulpy_tpu.core.layouts import GLWEPlaintext
from poulpy_tpu.core.prepared import ggsw_prepare, glwe_secret_prepare
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source
from poulpy_tpu.utils.compile_cache import enable_compile_cache
from poulpy_tpu.utils.device import describe

# {9023, 8857, 8586}/s over 3 runs of baseline_bench.cpp
CPU_BASELINE_EXT_PRODUCTS_PER_S = 9_000.0
CPU_BASELINE_HOST = ("one thread of an AVX-512 x86 development host, "
                     "g++ -O3 -march=native, 2026-08-20")

N = 2048
BASE2K = 17
K_CT = 51
K_PT = 34
K_KEY = 68
DNUM = 3
BATCH = int(os.environ.get("BENCH_BATCH", "16384"))
ITERS = int(os.environ.get("BENCH_ITERS", "30"))
VERIFY_BATCH = 64
NPRIMES = 2      # 2 primes below 2^28 cover N=2048, base2k=17 exactly
PRIME_BITS = 28


def _problem(batch):
    m = get_module(N, NPRIMES, PRIME_BITS)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, Source(bytes(32))))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    msgs = np.random.default_rng(0).integers(
        -(2**15), 2**15, size=(batch, N), dtype=np.int64
    )
    pt = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(BASE2K, K_PT, 3, jnp.asarray(msgs)),
        base2k=BASE2K, k=K_PT,
    )
    ct = enc.glwe_encrypt_sk(
        m, pt, skp, BASE2K, K_CT, xe, xa, batch_shape=(batch,)
    )
    x = np.zeros(N, dtype=np.int64)
    x[1] = 1
    ggsw = ggsw_prepare(m, enc.ggsw_encrypt_sk(
        m, jnp.asarray(x), skp, BASE2K, K_KEY, dnum=DNUM,
        source_xe=xe, source_xa=xa,
    ))
    step = jax.jit(lambda g, c: glwe_external_product(m, c, g))
    return m, skp, msgs, ct, ggsw, step


def verify():
    """Device vs in-process CPU, bit for bit, then decrypt to X·m."""
    m, skp, msgs, ct, ggsw, step = _problem(VERIFY_BATCH)
    have = step(ggsw, ct)
    want = step(*jax.device_put((ggsw, ct), jax.devices("cpu")[0]))
    exact = bool(np.array_equal(np.asarray(have.data), np.asarray(want.data)))
    got = np.asarray(vec_znx.decode_vec_i64(
        BASE2K, K_PT, dec.glwe_decrypt(m, have, skp).data
    ))
    rot = np.concatenate([-msgs[:, -1:], msgs[:, :-1]], axis=-1)  # X·m
    dec_ok = bool(np.array_equal(got, rot))
    print(json.dumps({
        "metric": "verify", "device_vs_cpu_bit_exact": exact,
        "decrypt_exact": dec_ok, "batch": VERIFY_BATCH, **describe(),
    }), file=sys.stderr)
    if not (exact and dec_ok):
        raise SystemExit("verify FAILED")


def main():
    _, _, _, ct, ggsw, step = _problem(BATCH)
    ggsw, ct = jax.device_put((ggsw, ct), jax.devices()[0])
    out = jax.block_until_ready(step(ggsw, ct))     # compile + warm
    # each iteration consumes the previous output, so the calls serialize
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = step(ggsw, out)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    ops_per_s = BATCH * ITERS / dt
    return {
        "metric": "external_products_per_s_n2048",
        "value": ops_per_s,
        "unit": "ext-products/s",
        "vs_baseline": ops_per_s / CPU_BASELINE_EXT_PRODUCTS_PER_S,
        "baseline_host": CPU_BASELINE_HOST,
        "batch": BATCH,
        "iters": ITERS,
        **describe(),
    }


if __name__ == "__main__":
    enable_compile_cache()
    if "--verify" in sys.argv:
        verify()
    else:
        row = main()
        verify()
        print(json.dumps(row))
