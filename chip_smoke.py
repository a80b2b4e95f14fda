"""Smoke run of the torus-FHE main path on an NVIDIA GPU.

Five phases go through the public entry points, at the reference's own
parameter sets, with keys and ciphertext batches on the card:

  ext_product    core.external_product.glwe_external_product
                 N=2048, base2k 17, ct k 51, GGSW k 68 dnum 3, batch 16384
  keyswitch      core.keyswitching.glwe_keyswitch
                 N=2048, base2k 17, key k 68 dnum 3, batch 256 distinct cts
  gate_nand      binfhe.gates.gate_nand, block-binary CGGI
                 GateParams(n_lwe=568, block_size=8): N=1024, batch 1024
  ckks_mul       ckks.ops.mul + rescale, i64 exit
                 N=2048, base2k 17, k 95, log_delta 22, batch 256
  ckks_mul_wide  ckks.ops.mul, wide (i128-twin) exit
                 N=2048, base2k 52, k 95, log_delta 30, batch 256

Each phase is checked twice.  A slice of the batch must be bit-identical to
the same jitted function run on the in-process CPU backend: the device path
is integer arithmetic only (no float matrix product, so no TF32), and
wrapping int64 sums are exact in any order, so the tolerance is 0.  And the
whole batch must decrypt to the expected plaintext (CKKS: max slot error
< 1e-3 at log_delta 30, scaled by 2^(30 - log_delta) below it).  Per phase the script prints compile seconds, seconds per steady
call, ops/s and the process's peak device memory: smoke readings of the card
named above them, not benchmark numbers.

The last line of stdout, {"ok": true, "device": {...}}, is printed only when
every phase passed on a GPU.  Any failure raises and exits non-zero; nothing
falls back to the CPU.  Everything runs in this one process.

  python chip_smoke.py                one GPU, the five phases
  python chip_smoke.py --four-cards   four GPUs: dp-sharded gates, kp-sharded
                                      BRK, sp-sharded NTT, each vs card 0
  python chip_smoke.py --rehearse     the same phases at tiny sizes on the
                                      CPU (never prints the ok line); with
                                      --four-cards, on 4 virtual CPU devices
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    n: int                  # ring degree of the core and CKKS phases
    ext_batch: int
    ks_batch: int
    ckks_batch: int
    slice: int              # ciphertexts compared against the CPU
    gate: dict              # binfhe.gates.GateParams overrides
    gate_batch: int
    gate_slice: int
    ckks_hw: int            # Hamming weight of the wide-CKKS secret
    # four-card phases
    dp_batch: int
    kp_batch: int
    sp_log_n: int


FULL = Sizes(
    n=2048, ext_batch=16384, ks_batch=256, ckks_batch=256, slice=64,
    gate=dict(n_lwe=568, block_size=8), gate_batch=1024, gate_slice=16,
    ckks_hw=192,
    dp_batch=4096, kp_batch=1024, sp_log_n=15,
)

TINY = Sizes(
    n=64, ext_batch=8, ks_batch=8, ckks_batch=4, slice=4,
    gate=dict(n_glwe=64, n_lwe=16, block_size=8, nprimes=4),
    gate_batch=8, gate_slice=4, ckks_hw=16,
    dp_batch=8, kp_batch=4, sp_log_n=8,
)

# CKKS max slot error: 1e-3 at log_delta 30 (tests/test_wide.py).  The
# decode error is the coefficient error of the product over the scale
# 2^log_delta, so at a smaller log_delta the same noise allows a bound
# 2^(30 - log_delta) times larger.
def ckks_max_err(log_delta: int) -> float:
    return 1e-3 * 2.0 ** (30 - log_delta)


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def _emit(row: dict):
    print(json.dumps(row), flush=True)


# --------------------------------------------------------------------------
# Phase runner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Phase:
    name: str
    fn: object              # jitted: fn(*keys, *batch_args) -> output pytree
    keys: tuple             # key pytrees (not sliced)
    batch_args: tuple       # pytrees with a leading batch axis
    batch: int
    slice: int
    check: object           # check(output) -> dict of decrypt results; raises


def _slice(tree, k):
    import jax

    return jax.tree.map(lambda x: x[:k], tree)


def run_phase(ph: Phase, dev, cpu, card: str, setup_s: float):
    """Compile, time, compare a slice against the CPU, decrypt-check."""
    import jax

    args = ph.keys + ph.batch_args
    t0 = time.perf_counter()
    compiled = ph.fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))

    # the same jitted function on the in-process CPU backend, on a slice
    cpu_args = jax.device_put(ph.keys + _slice(ph.batch_args, ph.slice), cpu)
    with jax.default_device(cpu):
        ref = jax.block_until_ready(ph.fn(*cpu_args))
    got_leaves = jax.tree.leaves(_slice(out, ph.slice))
    ref_leaves = jax.tree.leaves(ref)
    exact = len(got_leaves) == len(ref_leaves) and all(
        np.array_equal(np.asarray(g), np.asarray(r))
        for g, r in zip(got_leaves, ref_leaves)
    )
    _require(exact, f"{ph.name}: device slice differs from the CPU result")

    dec = ph.check(out)
    stats = dev.memory_stats() or {}
    _emit({
        "phase": ph.name,
        "reading": f"smoke, {card}",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "batch": ph.batch,
        "setup_s": setup_s,
        "compile_s": compile_s,
        "step_s": step_s,
        "ops_per_s": ph.batch / step_s,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
        "output_bytes": getattr(mem, "output_size_in_bytes", None),
        "cpu_slice": ph.slice,
        "cpu_slice_bit_exact": exact,
        **dec,
    })


# --------------------------------------------------------------------------
# The five one-card phases
# --------------------------------------------------------------------------

BASE2K, K_CT, K_PT, K_KEY, DNUM = 17, 51, 34, 68, 3


def _encode_msgs(msgs):
    import jax.numpy as jnp

    from poulpy_tpu.core.layouts import GLWEPlaintext
    from poulpy_tpu.hal import vec_znx

    return GLWEPlaintext(
        data=vec_znx.encode_vec_i64(BASE2K, K_PT, 3, jnp.asarray(msgs)),
        base2k=BASE2K, k=K_PT,
    )


def _decode_glwe(m, data, skp):
    from poulpy_tpu.core import decryption as dec
    from poulpy_tpu.core.layouts import GLWECiphertext
    from poulpy_tpu.hal import vec_znx

    ct = GLWECiphertext(data=data, base2k=BASE2K, k=K_CT)
    pt = dec.glwe_decrypt(m, ct, skp)
    return np.asarray(vec_znx.decode_vec_i64(BASE2K, K_PT, pt.data))


def phase_ext_product(sz: Sizes, dev) -> Phase:
    """Batched GLWE × GGSW(X) external product (bench.py configuration)."""
    import jax

    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.external_product import glwe_external_product
    from poulpy_tpu.core.prepared import ggsw_prepare, glwe_secret_prepare
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, batch = sz.n, sz.ext_batch
    m = get_module(n, 2, 28)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, Source(bytes(32))))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    msgs = np.random.default_rng(0).integers(
        -(2**15), 2**15, size=(batch, n), dtype=np.int64
    )
    ct = enc.glwe_encrypt_sk(
        m, _encode_msgs(msgs), skp, BASE2K, K_CT, xe, xa,
        batch_shape=(batch,),
    )
    x = np.zeros(n, dtype=np.int64)
    x[1] = 1
    ggsw = ggsw_prepare(m, enc.ggsw_encrypt_sk(
        m, x, skp, BASE2K, K_KEY, dnum=DNUM, source_xe=xe, source_xa=xa,
    ))
    ggsw, ct = jax.device_put((ggsw, ct), dev)

    @jax.jit
    def fn(ggsw, ct):
        return glwe_external_product(m, ct, ggsw).data

    def check(out):
        got = _decode_glwe(m, out, skp)
        want = np.concatenate([-msgs[:, -1:], msgs[:, :-1]], axis=-1)  # X·m
        bad = int(np.count_nonzero(got != want))
        _require(bad == 0, f"ext_product: {bad} coefficients decrypt wrong")
        return {"decrypt": "X*m exact", "decrypt_mismatches": bad}

    return Phase("ext_product", fn, (ggsw,), (ct,), batch, sz.slice, check)


def phase_keyswitch(sz: Sizes, dev) -> Phase:
    """Batched GLWE keyswitch of distinct ciphertexts (bench_full.py
    keyswitch setup)."""
    import jax

    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.keyswitching import glwe_keyswitch
    from poulpy_tpu.core.prepared import gglwe_prepare, glwe_secret_prepare
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, batch = sz.n, sz.ks_batch
    m = get_module(n, 2)
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sk1 = enc.secret_new(m, 1, src)
    sk2 = enc.secret_new(m, 1, src)
    sk2p = glwe_secret_prepare(m, sk2)
    msgs = np.random.default_rng(1).integers(
        -(2**15), 2**15, size=(batch, n), dtype=np.int64
    )
    ct = enc.glwe_encrypt_sk(
        m, _encode_msgs(msgs), glwe_secret_prepare(m, sk1), BASE2K, K_CT,
        xe, xa, batch_shape=(batch,),
    )
    ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, sk1, sk2p, BASE2K, K_KEY, dnum=DNUM, source_xe=xe, source_xa=xa,
    ))
    ksk, ct = jax.device_put((ksk, ct), dev)

    @jax.jit
    def fn(ksk, ct):
        return glwe_keyswitch(m, ct, ksk).data

    def check(out):
        bad = int(np.count_nonzero(_decode_glwe(m, out, sk2p) != msgs))
        _require(bad == 0, f"keyswitch: {bad} coefficients decrypt wrong")
        return {"decrypt": "m exact under the new key",
                "decrypt_mismatches": bad}

    return Phase("keyswitch", fn, (ksk,), (ct,), batch, sz.slice, check)


def _gate_keys(gate: dict, dev):
    import jax

    from poulpy_tpu.binfhe import gates

    params = gates.GateParams(**gate)
    keys, sk = gates.keygen(params)
    keys = dataclasses.replace(
        keys, **jax.device_put(
            {"brk": keys.brk, "to_lwe": keys.to_lwe, "lut": keys.lut}, dev)
    )
    return params, keys, sk


def _gate_fn(keys):
    """jit of gates.gate_nand with the key tensors as arguments."""
    import jax

    from poulpy_tpu.binfhe import gates

    @jax.jit
    def fn(brk, to_lwe, lut, c1, c2):
        k = dataclasses.replace(keys, brk=brk, to_lwe=to_lwe, lut=lut)
        return gates.gate_nand(k, c1, c2).data

    return fn


def _gate_inputs(params, sk, batch, seed):
    from poulpy_tpu.binfhe import gates
    from poulpy_tpu.hal.source import Source

    rng = np.random.default_rng(seed)
    b1 = rng.integers(0, 2, batch)
    b2 = rng.integers(0, 2, batch)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
    c2 = gates.encrypt_bit(params, b2, sk, xe, xa)
    return b1, b2, c1, c2


def _check_nand(name, params, sk, b1, b2):
    from poulpy_tpu.binfhe import gates
    from poulpy_tpu.core.layouts import LWECiphertext

    def check(out):
        ct = LWECiphertext(data=out, base2k=params.base2k, k=params.k_ct)
        bad = int(np.count_nonzero(gates.decrypt_bit(ct, sk) != 1 - (b1 & b2)))
        _require(bad == 0, f"{name}: {bad} gates decrypt wrong")
        return {"decrypt": "NAND truth table", "decrypt_mismatches": bad}

    return check


def phase_gate_nand(sz: Sizes, dev) -> Phase:
    """Batched block-binary NAND gate bootstrap (bench_full.py gate)."""
    import jax

    params, keys, sk = _gate_keys(sz.gate, dev)
    b1, b2, c1, c2 = _gate_inputs(params, sk, sz.gate_batch, 0)
    c1, c2 = jax.device_put((c1, c2), dev)
    return Phase(
        "gate_nand", _gate_fn(keys), (keys.brk, keys.to_lwe, keys.lut),
        (c1, c2), sz.gate_batch, sz.gate_slice,
        _check_nand("gate_nand", params, sk, b1, b2),
    )


def _phase_ckks(name, sz: Sizes, dev, *, nprimes, base2k, k_ct, k_key, dnum,
                log_delta, log_budget, rescale_bits, secret_kw) -> Phase:
    import jax

    import poulpy_tpu.ckks.ops as ck
    from poulpy_tpu.ckks.encoder import Encoder
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.prepared import (
        glwe_secret_prepare,
        glwe_tensor_key_prepare,
    )
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    n, batch = sz.n, sz.ckks_batch
    m = get_module(n, nprimes, 28)
    sk = enc.secret_new(m, 1, Source(bytes(32)), **secret_kw)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(
        m, sk, skp, base2k, k_key, dnum=dnum, source_xe=xe, source_xa=xa,
    ))
    encd = Encoder(n)
    rng = np.random.default_rng(3)
    z1, z2 = (rng.normal(size=(batch, n // 2))
              + 1j * rng.normal(size=(batch, n // 2)) for _ in range(2))
    c1, c2 = (
        ck.encrypt_sk(
            m, ck.encode(encd, z, base2k, k_ct, log_delta, log_budget),
            skp, k_ct, xe, xa, batch_shape=(batch,),
        )
        for z in (z1, z2)
    )
    tsk, c1, c2 = jax.device_put((tsk, c1, c2), dev)

    @jax.jit
    def fn(tsk, a, b):
        out = ck.mul(m, a, b, tsk)
        return ck.rescale(out, rescale_bits) if rescale_bits else out

    bound = ckks_max_err(log_delta)

    def check(out):
        got = ck.decode(encd, ck.decrypt(m, out, skp))
        err = float(np.abs(got - z1 * z2).max())
        _require(err < bound, f"{name}: max slot error {err} >= {bound}")
        return {"decrypt": f"slots within {bound}", "max_slot_error": err}

    return Phase(name, fn, (tsk,), (c1, c2), batch, sz.slice, check)


def phase_ckks_mul(sz: Sizes, dev) -> Phase:
    """CKKS ct×ct + rescale at base2k 17 (bench_full.py bench_ckks_mul)."""
    return _phase_ckks(
        "ckks_mul", sz, dev, nprimes=2, base2k=17, k_ct=95, k_key=95,
        dnum=6, log_delta=22, log_budget=30, rescale_bits=5, secret_kw={},
    )


def phase_ckks_mul_wide(sz: Sizes, dev) -> Phase:
    """CKKS ct×ct at the reference demo base2k 52, through the wide exit
    (bench_full.py bench_ckks_mul_wide).  The product keeps 5 bits of
    budget at this configuration and |z1·z2| needs them all, so no rescale
    follows the mul."""
    return _phase_ckks(
        "ckks_mul_wide", sz, dev, nprimes=5, base2k=52, k_ct=95, k_key=156,
        dnum=2, log_delta=30, log_budget=35, rescale_bits=0,
        secret_kw={"dist": "ternary_hw", "hw": sz.ckks_hw},
    )


ONE_CARD_PHASES = (phase_ext_product, phase_keyswitch, phase_gate_nand,
                   phase_ckks_mul, phase_ckks_mul_wide)


# --------------------------------------------------------------------------
# Four-card phases: each sharded result vs the single-card result on card 0
# --------------------------------------------------------------------------

def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return out, first_s, time.perf_counter() - t0


def _check_sharded(name, have, want, ndev, card, extra):
    got_devs = len(have.sharding.device_set)
    _require(got_devs == ndev,
             f"{name}: output spans {got_devs} devices, not {ndev}")
    exact = np.array_equal(np.asarray(have), np.asarray(want))
    _require(exact, f"{name}: sharded result differs from card 0")
    _emit({"phase": name, "reading": f"smoke, {card}",
           "output_devices": got_devs, "bit_exact_vs_card0": exact, **extra})


def four_card_dp_gates(sz: Sizes, devs, card: str, gate_keys):
    """NAND batch dp-sharded over 4 devices (sharded_gate_bootstrap_fn)."""
    import jax
    from jax.sharding import Mesh

    from poulpy_tpu.parallel.sharded import (
        shard_batch,
        sharded_gate_bootstrap_fn,
    )

    params, keys, sk = gate_keys()
    b1, b2, c1, c2 = _gate_inputs(params, sk, sz.dp_batch, 1)
    c1d, c2d = jax.device_put((c1.data, c2.data), devs[0])
    want, _, one_s = _timed(
        _gate_fn(keys), keys.brk, keys.to_lwe, keys.lut,
        c1.replace(data=c1d), c2.replace(data=c2d),
    )
    mesh = Mesh(np.array(devs), ("dp",))
    fn = sharded_gate_bootstrap_fn(keys, mesh, "nand")
    have, first_s, four_s = _timed(
        fn, shard_batch(mesh, c1.data), shard_batch(mesh, c2.data)
    )
    dec = _check_nand("dp_gates", params, sk, b1, b2)(have)
    _check_sharded("dp_gates", have, want, len(devs), card, {
        "batch": sz.dp_batch, "compile_and_first_s": first_s,
        "step_s_four_cards": four_s, "step_s_card0": one_s,
        "ops_per_s_four_cards": sz.dp_batch / four_s, **dec,
    })


def four_card_kp_blind_rotation(sz: Sizes, devs, card: str, gate_keys):
    """Block-binary blind rotation with the BRK split over kp=4: each card
    holds 2 of the 8 members of every block of the gate configuration's
    BRK."""
    import jax
    from jax.sharding import Mesh

    from poulpy_tpu.binfhe.blind_rotation import blind_rotation_execute_block
    from poulpy_tpu.core.layouts import LWECiphertext
    from poulpy_tpu.hal.normalization import vec_znx_normalize
    from poulpy_tpu.parallel.sharded import sharded_blind_rotation_block_fn

    params, keys, sk = gate_keys()
    _, _, c1, _ = _gate_inputs(params, sk, sz.kp_batch, 2)
    lwe = LWECiphertext(
        data=jax.device_put(vec_znx_normalize(params.base2k, c1.data),
                            devs[0]),
        base2k=params.base2k, k=params.k_ct,
    )
    block = params.block_size
    want, _, one_s = _timed(
        lambda l: blind_rotation_execute_block(
            keys.module, l, keys.lut, keys.brk, block), lwe,
    )
    mesh = Mesh(np.array(devs).reshape(1, len(devs)), ("dp", "kp"))
    fn = sharded_blind_rotation_block_fn(
        keys.module, mesh, keys.lut, keys.brk, block
    )
    have, first_s, four_s = _timed(fn, lwe)
    _check_sharded("kp_blind_rotation", have, want, len(devs), card, {
        "batch": sz.kp_batch, "n_lwe": params.n_lwe,
        "brk_bytes": int(keys.brk.pmats.nbytes),
        "compile_and_first_s": first_s, "step_s_four_cards": four_s,
        "step_s_card0": one_s,
    })


def four_card_sp_ntt(sz: Sizes, devs, card: str, gate_keys):
    """NTT with the ring degree split over sp=4: forward vs card 0, and the
    round trip back to the input.  Needs no keys."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.ntt import ntt_forward, to_residues
    from poulpy_tpu.parallel.sharded_ntt import (
        sharded_ntt_forward,
        sharded_ntt_inverse,
    )

    n, d = 1 << sz.sp_log_n, len(devs)
    m = get_module(n, 4)
    x = np.random.default_rng(4).integers(
        -(2**62), 2**62, size=(8, n), dtype=np.int64
    )
    r = jax.device_put(to_residues(m.tables, jnp.asarray(x)), devs[0])
    r = r.astype(jnp.int64)
    want, _, one_s = _timed(jax.jit(lambda v: ntt_forward(m.tables, v)), r)

    mesh = Mesh(np.array(devs), ("sp",))
    spec = P(None, None, "sp")

    def sharded(f):
        return jax.jit(jax.shard_map(
            lambda xl: f(m.basis.primes, n, d, "sp", xl),
            mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False,
        ))

    fwd, inv = sharded(sharded_ntt_forward), sharded(sharded_ntt_inverse)
    r_sp = jax.device_put(r, NamedSharding(mesh, spec))
    have, first_s, four_s = _timed(fwd, r_sp)
    back = jax.block_until_ready(inv(have))
    _require(np.array_equal(np.asarray(back), np.asarray(r)),
             "sp_ntt: sharded round trip does not return the input")
    _check_sharded("sp_ntt", have, want, d, card, {
        "n": n, "nprimes": 4, "compile_and_first_s": first_s,
        "step_s_four_cards": four_s, "step_s_card0": one_s,
        "round_trip_exact": True,
    })


# the key-free phase first, so a mesh fault shows before the keygen
FOUR_CARD_PHASES = (four_card_sp_ntt, four_card_dp_gates,
                    four_card_kp_blind_rotation)


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phases")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU; never prints the ok line")
    args = ap.parse_args(argv)

    import jax

    import poulpy_tpu  # noqa: F401  (enables 64-bit integers)
    from poulpy_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cpu = jax.devices("cpu")[0]
    ndev = 4 if args.four_cards else 1
    if args.rehearse:
        devs, sizes, card = jax.devices("cpu")[:ndev], TINY, "CPU rehearsal"
        _require(len(devs) == ndev,
                 f"rehearsal needs {ndev} CPU devices, found {len(devs)}")
    else:
        devs = [d for d in jax.devices() if d.platform == "gpu"][:ndev]
        if len(devs) < ndev:
            raise SmokeFailure(
                f"needs {ndev} GPU(s); JAX found {jax.devices()}"
            )
        sizes = FULL
        from poulpy_tpu.utils.device import card_info

        cards = card_info()
        card = cards[0]
        for line in cards:
            print(f"nvidia-smi: {line}", flush=True)
    print(f"jax.devices(): {jax.devices()}", flush=True)

    if args.four_cards:
        # built on first use and shared by the dp and kp phases
        gate_keys = functools.cache(lambda: _gate_keys(sizes.gate, devs[0]))
        for phase in FOUR_CARD_PHASES:
            phase(sizes, devs, card, gate_keys)
    else:
        for make in ONE_CARD_PHASES:
            t0 = time.perf_counter()
            phase = make(sizes, devs[0])
            run_phase(phase, devs[0], cpu, card, time.perf_counter() - t0)

    if args.rehearse:
        print("rehearsal passed (no device result)", flush=True)
        return 0
    d0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    # the CPU backend serves the reference comparison, so keep it loaded
    # when a platform list is given
    _plats = os.environ.get("JAX_PLATFORMS")
    if _plats and "cpu" not in _plats.split(","):
        os.environ["JAX_PLATFORMS"] = _plats + ",cpu"
    if "--rehearse" in sys.argv and "--four-cards" in sys.argv:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4"
        )
    sys.exit(main())
