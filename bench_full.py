"""Extended benchmark suite (the poulpy-bench analogue).

Prints one JSON line per metric, each with the device it ran on.
`bench.py` is the single headline line; this script covers the remaining
BASELINE.json metrics:
  - gate-bootstraps/s (batched NAND, TFHE-style params)
  - key-switch latency (single ciphertext) and batched throughput
  - CKKS mul + rescale at base2k 17 and mul at base2k 52 (wide exit)
"""

import json
import time
from functools import partial

import jax
import numpy as np

import jax.numpy as jnp

import poulpy_tpu  # noqa: F401  (enables 64-bit integers)
from poulpy_tpu.utils.compile_cache import enable_compile_cache
from poulpy_tpu.utils.device import describe

# Single-thread CPU block-binary blind-rotation denominator:
# baseline_gate_bench.cpp, an exact-oracle-gated FFT64 twin at the identical
# gate config.  BR loop only: mod-switch/extract/keyswitch omitted, which
# biases the denominator FAST, i.e. conservative.  Best of 3 quiet runs.
CPU_GATE_BOOTSTRAPS_PER_S = 110.0
CPU_BASELINE_HOST = ("one thread of an AVX-512 x86 development host, "
                     "g++ -O3 -march=native, 2026-08-21")


def bench_gate_bootstrap(batch=1024, iters=5):
    from poulpy_tpu.binfhe import gates
    from poulpy_tpu.hal.source import Source

    # TFHE-style sizing with a block-binary key (reference example uses
    # block_size 7 at n_lwe 567, bdd_arithmetic.rs:64-106; 8·71 here keeps
    # divisibility) — amortizes DFT round trips over each block
    params = gates.GateParams(n_lwe=568, block_size=8)
    keys, sk = gates.keygen(params)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    b1 = np.random.default_rng(0).integers(0, 2, batch)
    b2 = np.random.default_rng(1).integers(0, 2, batch)
    c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
    c2 = gates.encrypt_bit(params, b2, sk, xe, xa)

    out = gates.gate_nand(keys, c1, c2)  # compile + warm
    jax.block_until_ready(out.data)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = gates.gate_nand(keys, c1, c2)
    jax.block_until_ready(out.data)
    dt = time.perf_counter() - t0
    got = gates.decrypt_bit(out, sk)
    assert np.array_equal(got, 1 - (b1 & b2)), "NAND wrong on device!"
    return batch * iters / dt


def _keyswitch_setup():
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.layouts import GLWEPlaintext
    from poulpy_tpu.core.prepared import gglwe_prepare, glwe_secret_prepare
    from poulpy_tpu.hal import vec_znx
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, base2k, k_ct, k_key = 2048, 17, 51, 68
    m = get_module(n, 2)
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sk1 = enc.secret_new(m, 1, src)
    sk2 = enc.secret_new(m, 1, src)
    sk2p = glwe_secret_prepare(m, sk2)
    data = np.random.default_rng(0).integers(-(2**15), 2**15, n, dtype=np.int64)
    pt = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 34, 3, jnp.asarray(data)),
        base2k=base2k, k=34,
    )
    ct = enc.glwe_encrypt_sk(m, pt, glwe_secret_prepare(m, sk1), base2k, k_ct, xe, xa)
    ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, sk1, sk2p, base2k, k_key, dnum=3, source_xe=xe, source_xa=xa
    ))
    return m, ct, ksk


def bench_keyswitch(iters=50, donate=False):
    """Wall-clock p50 of a single dispatched keyswitch: host dispatch plus
    device time (bench_keyswitch_device isolates the device part).
    `donate=True` A/Bs buffer donation on the dispatch path."""
    from poulpy_tpu.core.keyswitching import glwe_keyswitch

    m, ct, ksk = _keyswitch_setup()

    jit = jax.jit if not donate else partial(jax.jit, donate_argnums=0)

    @jit
    def step(d):
        return glwe_keyswitch(m, ct.replace(data=d), ksk).data

    out = step(ct.data)
    jax.block_until_ready(out)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = step(out)
        jax.block_until_ready(out)
        lat.append(time.perf_counter() - t0)
    return float(np.percentile(np.array(lat), 50) * 1000)


def bench_keyswitch_device(chain=16, reps=5):
    """On-device single-ciphertext keyswitch latency: CHAIN dependent
    keyswitches inside ONE jitted scan (each consumes the previous output,
    so they serialize on device), amortizing the dispatch overhead away."""
    from poulpy_tpu.core.keyswitching import glwe_keyswitch

    m, ct, ksk = _keyswitch_setup()

    @jax.jit
    def chained(data):
        def step(d, _):
            c = ct.replace(data=d)
            return glwe_keyswitch(m, c, ksk).data, None

        out, _ = jax.lax.scan(step, data, None, length=chain)
        return out

    out = chained(ct.data)
    jax.block_until_ready(out)
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = chained(ct.data)
        jax.block_until_ready(out)
        lat.append((time.perf_counter() - t0) / chain)
    return float(np.median(np.array(lat)) * 1000)


def bench_keyswitch_batched(batch=256, iters=10):
    """Batched keyswitch throughput (cts/s) at the headline config."""
    from poulpy_tpu.core.keyswitching import glwe_keyswitch

    m, ct, ksk = _keyswitch_setup()
    data = jnp.broadcast_to(ct.data, (batch,) + ct.data.shape)

    @jax.jit
    def step(d):
        return glwe_keyswitch(m, ct.replace(data=d), ksk).data

    out = step(data)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(out)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return batch * iters / dt


def bench_ckks_mul(batch=256, iters=5):
    """Batched CKKS ct×ct multiply (tensor + relinearize) + rescale at
    N=2048 (the ckks_mul/ckks_composite poulpy-bench analogue)."""
    import poulpy_tpu.ckks.ops as ck
    from poulpy_tpu.ckks.encoder import Encoder
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.prepared import (
        glwe_secret_prepare,
        glwe_tensor_key_prepare,
    )
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, base2k, k_ct, k_key, log_delta, log_budget = 2048, 17, 95, 95, 22, 30
    m = get_module(n, 2, 28)   # 2 lazy primes cover the 49-bit conv bound
    s = Source(bytes(32))
    sk = enc.secret_new(m, 1, s)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(
        m,
        enc.glwe_tensor_key_encrypt_sk(
            m, sk, skp, base2k, k_key, dnum=6, source_xe=xe, source_xa=xa
        ),
    )
    encd = Encoder(n)
    rng = np.random.default_rng(3)
    z = rng.normal(size=n // 2) + 1j * rng.normal(size=n // 2)
    pt = ck.encode(encd, z, base2k, k_ct, log_delta, log_budget)
    c1 = ck.encrypt_sk(m, pt, skp, k_ct, xe, xa)
    c2 = ck.encrypt_sk(m, pt, skp, k_ct, xe, xa)

    d1 = jnp.broadcast_to(c1.glwe.data, (batch,) + c1.glwe.data.shape)
    d2 = jnp.broadcast_to(c2.glwe.data, (batch,) + c2.glwe.data.shape)

    @jax.jit
    def step(a_data, b_data):
        a = c1.replace(glwe=c1.glwe.replace(data=a_data))
        b = c2.replace(glwe=c2.glwe.replace(data=b_data))
        out = ck.mul(m, a, b, tsk)
        return ck.rescale(out, 5).glwe.data

    out = step(d1, d2)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(d1, d2)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return batch * iters / dt


def bench_ckks_mul_wide(batch=256, iters=5):
    """CKKS ct×ct at the reference NTT120 demo parameterization (base2k=52,
    k=95, HW=192 — poulpy-ckks/examples/poly2.rs:48-61): exercises the wide
    (i128-twin) big-accumulator exit (hal/wide.py) on device."""
    import poulpy_tpu.ckks.ops as ck
    from poulpy_tpu.ckks.encoder import Encoder
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.prepared import (
        glwe_secret_prepare,
        glwe_tensor_key_prepare,
    )
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, base2k, k_ct, k_key, log_delta, log_budget = 2048, 52, 95, 156, 30, 35
    # 5 primes below 2^28 (~140-bit modulus) cover the 116-bit bound; the
    # concrete basis is a free parameter (hal/primes.py)
    m = get_module(n, 5, 28)
    s = Source(bytes(32))
    sk = enc.secret_new(m, 1, s, dist="ternary_hw", hw=192)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(
        m,
        enc.glwe_tensor_key_encrypt_sk(
            m, sk, skp, base2k, k_key, dnum=2, source_xe=xe, source_xa=xa
        ),
    )
    encd = Encoder(n)
    rng = np.random.default_rng(5)
    z = rng.normal(size=n // 2) + 1j * rng.normal(size=n // 2)
    pt = ck.encode(encd, z, base2k, k_ct, log_delta, log_budget)
    c1 = ck.encrypt_sk(m, pt, skp, k_ct, xe, xa)
    c2 = ck.encrypt_sk(m, pt, skp, k_ct, xe, xa)
    d1 = jnp.broadcast_to(c1.glwe.data, (batch,) + c1.glwe.data.shape)
    d2 = jnp.broadcast_to(c2.glwe.data, (batch,) + c2.glwe.data.shape)

    @jax.jit
    def step(a_data, b_data):
        a = c1.replace(glwe=c1.glwe.replace(data=a_data))
        b = c2.replace(glwe=c2.glwe.replace(data=b_data))
        return ck.mul(m, a, b, tsk).glwe.data

    out = step(d1, d2)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(d1, d2)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return batch * iters / dt


def _emit(rows, row):
    # print incrementally: a crash in a later bench must not lose the
    # rows already measured
    row.update(describe())
    rows.append(row)
    print(json.dumps(row), flush=True)


def main():
    _validate_flags()   # fail fast on bad argv before the run
    enable_compile_cache()
    rows = []
    gbs = bench_gate_bootstrap()
    _emit(rows, {
        "metric": "gate_bootstraps_per_s_nand_n1024",
        "value": gbs, "unit": "bootstraps/s",
        "vs_baseline": gbs / CPU_GATE_BOOTSTRAPS_PER_S,
        "baseline_host": CPU_BASELINE_HOST,
    })
    # primary keyswitch latency: chained scan on the device, the number
    # comparable to the reference's per-op latency
    dev = bench_keyswitch_device()
    _emit(rows, {
        "metric": "keyswitch_device_latency_n2048",
        "value": dev, "unit": "ms", "vs_baseline": None,
        "role": "primary_p50",
    })
    p50 = bench_keyswitch()
    _emit(rows, {
        "metric": "keyswitch_p50_latency_n2048",
        "value": p50, "unit": "ms", "vs_baseline": None,
        "role": "dispatch_latency",
        "note": "single-dispatch wall clock: host dispatch + device time",
    })
    p50d = bench_keyswitch(donate=True)
    _emit(rows, {
        "metric": "keyswitch_p50_donated_n2048",
        "value": p50d, "unit": "ms", "vs_baseline": None,
        "role": "dispatch_latency",
        "note": "same, with donated input buffer",
    })
    thr = bench_keyswitch_batched()
    _emit(rows, {
        "metric": "keyswitch_throughput_n2048",
        "value": thr, "unit": "cts/s", "vs_baseline": None,
    })
    ck = bench_ckks_mul()
    _emit(rows, {
        "metric": "ckks_mul_rescale_per_s_n2048",
        "value": ck, "unit": "muls/s", "vs_baseline": None,
    })
    ckw = bench_ckks_mul_wide()
    _emit(rows, {
        "metric": "ckks_mul_wide_base2k52_per_s_n2048",
        "value": ckw, "unit": "muls/s", "vs_baseline": None,
    })
    _baseline_compare(rows)


# Lower-is-better metrics for --baseline regression comparison.
_LATENCY_METRICS = {"keyswitch_p50_latency_n2048",
                    "keyswitch_p50_donated_n2048",
                    "keyswitch_device_latency_n2048"}


def _baseline_dir():
    from pathlib import Path

    return Path(__file__).parent / ".bench_baselines"


def _flag_value(flag: str) -> str | None:
    """THE parser for --save-baseline/--baseline NAME — shared by the
    up-front validator and the post-run comparator so the two can't
    drift."""
    import sys

    args = sys.argv[1:]
    if flag not in args:
        return None
    i = args.index(flag)
    if i + 1 >= len(args) or args[i + 1].startswith("--"):
        raise SystemExit(f"{flag} requires a NAME argument")
    return args[i + 1]


def _validate_flags():
    """Fail fast on bad argv before the full run."""
    name = _flag_value("--baseline")
    _flag_value("--save-baseline")
    if name is not None:
        p = _baseline_dir() / f"{name}.json"
        if not p.exists():
            raise SystemExit(f"--baseline {name}: {p} does not exist")


def _baseline_compare(rows, tol=0.05):
    """poulpy-bench `standard` analogue (SURVEY §2.7: Criterion
    --save-baseline/--baseline): `--save-baseline NAME` stores this run
    under .bench_baselines/NAME.json; `--baseline NAME` diffs against a
    stored run and exits 1 on any metric >5% worse."""
    bdir = _baseline_dir()
    name = _flag_value("--save-baseline")
    if name:
        bdir.mkdir(exist_ok=True)
        (bdir / f"{name}.json").write_text(json.dumps(rows, indent=1))
        print(json.dumps({"baseline_saved": name}))
    name = _flag_value("--baseline")
    if name:
        base = {r["metric"]: r for r in
                json.loads((bdir / f"{name}.json").read_text())}
        regressed = []
        for r in rows:
            b = base.get(r["metric"])
            if b is None or not b["value"]:
                continue
            ratio = r["value"] / b["value"]
            worse = ratio > 1 + tol if r["metric"] in _LATENCY_METRICS \
                else ratio < 1 - tol
            if worse:
                regressed.append(r["metric"])
            print(json.dumps({
                "metric": r["metric"], "baseline": b["value"],
                "now": r["value"], "ratio": round(ratio, 3),
                "regressed": worse,
            }))
        if regressed:
            raise SystemExit(f"regressions vs '{name}': {regressed}")


if __name__ == "__main__":
    main()
