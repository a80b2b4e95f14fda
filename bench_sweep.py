"""Primitive-op benchmark sweep — the poulpy-bench analogue.

The reference ships ~26 criterion benches under poulpy-bench/benches/
(vec_znx_*.rs, vec_znx_dft_*.rs, svp_*.rs, vmp_*.rs, convolution.rs)
sweeping log_n.  This sweeps the same primitive surface on one device,
batched (the throughput axis), and prints one JSON line per (op, log_n)
with ops/s (per single un-batched op) and the device it ran on.

Measurement method: every op is timed as a CHAIN of dependent applications
inside ONE jitted lax.scan, so per-call dispatch cost amortizes away.  Each
scan iteration perturbs the input with the loop counter (no hoisting) and
folds a full-array checksum into the carry (no DCE), so the per-iteration
time is device time plus one reduce.

Usage:  python bench_sweep.py [--logn 10 11 12] [--batch 64]
        [--chain 32] [--reps 3]
"""

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import poulpy_tpu  # noqa: F401  (enables 64-bit integers)
from poulpy_tpu.utils.compile_cache import enable_compile_cache
from poulpy_tpu.utils.device import describe

BASE2K = 17
SIZE = 3          # ct limbs (k = 51)
DNUM = 3
NPRIMES = 2


def _chain_time(op_fn, chain, reps):
    """Median seconds per op application: `chain` dependent applications
    of op_fn(i) inside one jitted scan.  op_fn takes the iteration counter
    (int64 scalar) and returns one array; the counter perturbation defeats
    loop-invariant hoisting and the full-sum carry defeats DCE."""

    @jax.jit
    def run(c0):
        def body(carry, _):
            i, s = carry
            out = op_fn(i + (s & 1))      # data-dependent: serializes
            return (i + 1, s + jnp.sum(out).astype(jnp.int64)), None

        (_, s), _ = jax.lax.scan(
            body, (jnp.int64(0), c0), None, length=chain
        )
        return s

    s = run(jnp.int64(0))
    jax.block_until_ready(s)              # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        s = run(s & 1)
        jax.block_until_ready(s)
        times.append((time.perf_counter() - t0) / chain)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--logn", type=int, nargs="+", default=[10, 11, 12, 13])
    ap.add_argument("--batch", type=int,
                    default=int(os.environ.get("BENCH_BATCH", 64)))
    ap.add_argument("--chain", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    enable_compile_cache()
    device = describe()

    from poulpy_tpu.hal import dft, vec_znx
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.normalization import vec_znx_normalize

    B = args.batch
    rng = np.random.default_rng(0)
    results = []

    for logn in args.logn:
        n = 1 << logn
        module = get_module(n, NPRIMES)
        a = jnp.asarray(
            rng.integers(-(2**40), 2**40, size=(B, SIZE, n), dtype=np.int64)
        )
        b = jnp.asarray(
            rng.integers(-(2**40), 2**40, size=(B, SIZE, n), dtype=np.int64)
        )
        svp_poly = jnp.asarray(
            rng.integers(-(2**20), 2**20, size=(n,), dtype=np.int64)
        )
        # MatZnx [rows, cols_in, cols_out, size, N] — keyswitch-shaped VMP
        pmat_raw = jnp.asarray(rng.integers(
            -(2**40), 2**40, size=(DNUM, 1, 2, SIZE, n), dtype=np.int64
        ))
        xd = dft.dft_apply(module, a)
        svp_prep = dft.svp_prepare(module, svp_poly)
        pmat = dft.vmp_prepare(module, pmat_raw)
        adft = dft.dft_apply(module, a[:, None, :DNUM, :])
        cl = dft.cnv_prepare_left(module, a)
        cr = dft.cnv_prepare_right(module, b)

        # each op as fn(counter) -> array (counter folds into the input)
        ops = {
            "vec_znx_add": lambda i: vec_znx.vec_znx_add(a + i, b),
            "vec_znx_sub": lambda i: vec_znx.vec_znx_sub(a + i, b),
            "vec_znx_rotate": lambda i: vec_znx.vec_znx_rotate(3, a + i),
            "vec_znx_normalize": lambda i: vec_znx_normalize(
                BASE2K, a + i
            ),
            "vec_znx_dft": lambda i: dft.dft_apply(module, a + i),
            "vec_znx_idft": lambda i: dft.idft_apply(module, xd + i),
            "svp_apply": lambda i: dft.svp_apply(
                module, xd + i, svp_prep
            ),
            "vmp_apply": lambda i: dft.vmp_apply(module, adft + i, pmat),
            "convolution": lambda i: dft.cnv_apply(
                module, cl + i, cr, 2 * SIZE - 1
            ),
        }

        for name, fn in ops.items():
            dt = _chain_time(fn, args.chain, args.reps)
            per_op = dt / B
            rec = {
                "op": name,
                "log_n": logn,
                "batch": B,
                "chain": args.chain,
                "us_per_op": per_op * 1e6,
                "ops_per_s": 1.0 / per_op,
                **device,
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)

    return results


if __name__ == "__main__":
    main()
