"""bin-fhe tests: LUT, blind rotation, gate bootstrap truth tables,
circuit bootstrapping (functional equivalents of
poulpy-bin-fhe/src/*/tests/)."""

import numpy as np
import pytest

import jax.numpy as jnp

from poulpy_tpu.binfhe import gates
from poulpy_tpu.binfhe.blind_rotation import (
    blind_rotation_execute,
    blind_rotation_key_encrypt_sk,
    mod_switch_2n,
)
from poulpy_tpu.binfhe.circuit_bootstrapping import (
    circuit_bootstrap,
    circuit_bootstrapping_keygen,
)
from poulpy_tpu.binfhe.lut import lookup_table_new
from poulpy_tpu.core import decryption as dec
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.external_product import glwe_external_product
from poulpy_tpu.core.layouts import GLWECiphertext, GLWEPlaintext
from poulpy_tpu.core.prepared import ggsw_prepare, glwe_secret_prepare
from poulpy_tpu.hal import vec_znx, znx
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source

RNG = np.random.default_rng(5)


def test_lut_set_semantics():
    n, base2k, k = 32, 17, 34
    f = np.arange(8, dtype=np.int64)
    lut = lookup_table_new(n, base2k, k, f, f_k=6)
    # after drift pre-rotation, window centers decode back to f values
    from poulpy_tpu.hal.vec_znx import decode_vec_i64, vec_znx_rotate

    step = n // 8
    for j in range(8):
        # rotate so window j's center lands on coefficient 0
        rot = vec_znx_rotate(-(j * step), lut.data[0])
        val = np.asarray(decode_vec_i64(base2k, 6, rot))[0]
        assert val == f[j], (j, val)


def test_mod_switch_2n():
    base2k, k = 17, 34
    n = 64
    # encrypt "plaintext-only" LWE with zero secret to check rounding
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    sk = jnp.zeros((8,), jnp.int64)
    for val in [0, 5, -5, 31, -32]:
        pt = np.zeros((2, 1), dtype=np.int64)
        pt[0, 0] = val << (base2k - 7)  # value val/2^7
        ct = enc.lwe_encrypt_sk(None, jnp.asarray(pt), sk, base2k, k, xe, xa)
        idx = mod_switch_2n(2 * n, ct, rot_dir="right")
        # expected: round(val/2^7 · 2N) = val
        assert abs(int(idx[0]) - val) <= 1, (val, int(idx[0]))


@pytest.fixture(scope="module")
def br_ctx():
    m = get_module(64, 4)
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    n_lwe = 16
    sk_lwe = src.binary_prob((n_lwe,))
    sk_glwe = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    brk = blind_rotation_key_encrypt_sk(
        m, jnp.asarray(sk_lwe), skp, 17, 68, 4, xe, xa
    )
    return m, sk_lwe, sk_glwe, skp, brk


def test_blind_rotation_value(br_ctx):
    m, sk_lwe, sk_glwe, skp, brk = br_ctx
    base2k, k_ct = 17, 34
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    # LUT f(x) = x over 5-bit domain
    f = np.arange(32, dtype=np.int64)
    lut = lookup_table_new(m.n, base2k, 34, f, f_k=10)
    for msg in [0, 3, 17, 31]:
        pt = np.zeros((2, 1), dtype=np.int64)
        # msg/2^6: the 32-entry LUT covers the positive half-circle, so the
        # domain encoding is log_domain+1 = 6 bits (phase = msg·2N/2^6)
        pt[0, 0] = msg << (base2k - 6)
        lwe = enc.lwe_encrypt_sk(
            None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, k_ct, xe, xa
        )
        acc = blind_rotation_execute(m, lwe, lut, brk)
        glwe = GLWECiphertext(data=acc, base2k=base2k, k=lut.size * base2k)
        ptd = dec.glwe_decrypt(m, glwe, skp)
        val = np.asarray(vec_znx.decode_vec_i64(base2k, 10, ptd.data))[0]
        assert abs(int(val) - msg) <= 1, (msg, val)


def test_blind_rotation_batched(br_ctx):
    m, sk_lwe, sk_glwe, skp, brk = br_ctx
    base2k, k_ct = 17, 34
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    f = np.arange(32, dtype=np.int64)
    lut = lookup_table_new(m.n, base2k, 34, f, f_k=10)
    msgs = np.array([1, 7, 20, 30], dtype=np.int64)
    pt = np.zeros((4, 2, 1), dtype=np.int64)
    pt[:, 0, 0] = msgs << (base2k - 6)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, k_ct, xe, xa
    )
    acc = blind_rotation_execute(m, lwe, lut, brk)
    assert acc.shape[0] == 4
    glwe = GLWECiphertext(data=acc, base2k=base2k, k=lut.size * base2k)
    ptd = dec.glwe_decrypt(m, glwe, skp)
    vals = np.asarray(vec_znx.decode_vec_i64(base2k, 10, ptd.data))[:, 0]
    assert np.max(np.abs(vals - msgs)) <= 1, (msgs, vals)


@pytest.fixture(scope="module")
def gate_ctx():
    params = gates.GateParams(
        n_glwe=64, n_lwe=16, base2k=17, k_ct=34, k_brk=68,
        dnum_brk=4, k_ksk=51, dnum_ksk=2, nprimes=4,
    )
    keys, sk = gates.keygen(params)
    return params, keys, sk


@pytest.mark.parametrize(
    "gate,table",
    [
        (gates.gate_nand, lambda a, b: 1 - (a & b)),
        (gates.gate_and, lambda a, b: a & b),
        (gates.gate_or, lambda a, b: a | b),
        (gates.gate_nor, lambda a, b: 1 - (a | b)),
        (gates.gate_xor, lambda a, b: a ^ b),
        (gates.gate_xnor, lambda a, b: 1 - (a ^ b)),
    ],
)
def test_gate_truth_tables(gate_ctx, gate, table):
    params, keys, sk = gate_ctx
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    for b1 in (0, 1):
        for b2 in (0, 1):
            c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
            c2 = gates.encrypt_bit(params, b2, sk, xe, xa)
            out = gate(keys, c1, c2)
            assert gates.decrypt_bit(out, sk) == table(b1, b2), (b1, b2)


def test_gate_batched(gate_ctx):
    params, keys, sk = gate_ctx
    xe, xa = Source(b"\x07" * 32), Source(b"\x08" * 32)
    b1 = np.array([0, 0, 1, 1])
    b2 = np.array([0, 1, 0, 1])
    c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
    c2 = gates.encrypt_bit(params, b2, sk, xe, xa)
    out = gates.gate_nand(keys, c1, c2)
    got = gates.decrypt_bit(out, sk)
    assert np.array_equal(got, 1 - (b1 & b2))


def test_circuit_bootstrap_to_constant(br_ctx):
    m, sk_lwe, sk_glwe, skp, brk = br_ctx
    base2k = 17
    xe, xa = Source(b"\x09" * 32), Source(b"\x0a" * 32)
    cbt = circuit_bootstrapping_keygen(
        m, sk_lwe, sk_glwe, skp, base2k,
        k_brk=68, dnum_brk=4, k_atk=68, dnum_atk=4, k_tsk=68, dnum_tsk=4,
        source_xe=xe, source_xa=xa,
    )
    log_domain = 3
    msg = 1  # GGSW(1) acts as identity in external product
    pt = np.zeros((2, 1), dtype=np.int64)
    pt[0, 0] = msg << (base2k - 1 - log_domain)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, 34, xe, xa
    )
    # dnum_res=3 → GGSW k=51: the gadget truncation floor 2^-51 stays well
    # under the tolerance (reference example uses GGSW k=51/dnum=3,
    # poulpy-bin-fhe/examples/bdd_arithmetic.rs:64-106)
    ggsw = circuit_bootstrap(m, lwe, log_domain, cbt, dnum_res=3, k_res=51)
    # external product with GGSW(1) ≈ identity
    data = RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
    pt_g = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 30, 2, jnp.asarray(data)),
        base2k=base2k, k=30,
    )
    ct = enc.glwe_encrypt_sk(m, pt_g, skp, base2k, 51, xe, xa)
    out = glwe_external_product(m, ct, ggsw_prepare(m, ggsw))
    ptd = dec.glwe_decrypt(m, out, skp)
    got = np.asarray(vec_znx.decode_vec_i64(base2k, 30, ptd.data))
    err = np.abs(got - data).max()
    # three chained gadget stages (blind rotation → trace keyswitches →
    # GGSW expansion → external product) leave ~2^-40 noise at these toy
    # parameters → a few hundred at the 2^-30 plaintext scale
    assert err <= 1024, err


@pytest.mark.slow  # superseded by tests/test_bdd_circuits.py encrypted sweep
def test_fheuint_bdd_add(br_ctx):
    """End-to-end BDD arithmetic: prepared 4-bit uints through the add
    circuit (bdd_arithmetic test_suite analogue, scaled to toy params)."""
    from poulpy_tpu.binfhe import bdd as bddm
    from poulpy_tpu.core.conversion import glwe_to_lwe_key_encrypt_sk

    m, sk_lwe, sk_glwe, skp, brk = br_ctx
    base2k = 17
    xe, xa = Source(b"\x0b" * 32), Source(b"\x0c" * 32)
    cbt = circuit_bootstrapping_keygen(
        m, sk_lwe, sk_glwe, skp, base2k,
        k_brk=68, dnum_brk=4, k_atk=68, dnum_atk=4, k_tsk=68, dnum_tsk=4,
        source_xe=xe, source_xa=xa,
    )
    n_lwe = len(sk_lwe)
    ks_lwe = glwe_to_lwe_key_encrypt_sk(
        m, jnp.asarray(sk_lwe), sk_glwe, base2k, 51, dnum=3,
        source_xe=xe, source_xa=xa,
    )
    key = bddm.BDDKey(
        cbt=cbt, ks_lwe=ks_lwe, n_lwe=n_lwe, base2k=base2k,
        k_ct=51, dnum_ggsw=3, k_ggsw=51,
    )
    width = 4
    va, vb = 11, 7
    ca = bddm.fheuint_encrypt(m, va, width, skp, base2k, 51, xe, xa)
    cb = bddm.fheuint_encrypt(m, vb, width, skp, base2k, 51, xe, xa)
    pa = bddm.fheuint_prepare(m, ca, key)
    pb = bddm.fheuint_prepare(m, cb, key)
    out = bddm.fheuint_op(m, "add", pa, pb, base2k, 51)
    got = bddm.fheuint_decrypt(m, bddm.FheUint(glwe=out, width=width), skp)
    assert got == (va + vb) % 16, got


def test_blind_rotation_block_binary():
    """Block-binary path (execute_block_binary) vs expected LUT values."""
    from poulpy_tpu.binfhe.blind_rotation import blind_rotation_execute_block

    m = get_module(64, 4)
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    n_lwe, block = 16, 4
    sk_lwe = src.binary_block(n_lwe, block)
    sk_glwe = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    brk = blind_rotation_key_encrypt_sk(
        m, jnp.asarray(sk_lwe), skp, 17, 68, 4, xe, xa
    )
    base2k = 17
    f = np.arange(32, dtype=np.int64)
    lut = lookup_table_new(m.n, base2k, 34, f, f_k=10)
    msgs = np.array([0, 5, 21, 31], dtype=np.int64)
    pt = np.zeros((4, 2, 1), dtype=np.int64)
    pt[:, 0, 0] = msgs << (base2k - 6)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, 34, xe, xa
    )
    acc = blind_rotation_execute_block(m, lwe, lut, brk, block)
    glwe = GLWECiphertext(data=acc, base2k=base2k, k=lut.size * base2k)
    vals = np.asarray(
        vec_znx.decode_vec_i64(base2k, 10, dec.glwe_decrypt(m, glwe, skp).data)
    )[:, 0]
    assert np.max(np.abs(vals - msgs)) <= 1, (msgs, vals)


def test_blind_rotation_extended():
    """Extension-factor path: N=32 ring with ext=2 gives a 64-point domain
    (execute_block_binary_extended analogue)."""
    from poulpy_tpu.binfhe.blind_rotation import blind_rotation_execute_extended

    m = get_module(32, 4)
    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    n_lwe, block = 16, 4
    sk_lwe = src.binary_block(n_lwe, block)
    sk_glwe = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    brk = blind_rotation_key_encrypt_sk(
        m, jnp.asarray(sk_lwe), skp, 17, 68, 4, xe, xa
    )
    base2k = 17
    f = np.arange(32, dtype=np.int64)
    lut = lookup_table_new(m.n, base2k, 34, f, f_k=10, extension_factor=2)
    msgs = np.array([0, 3, 17, 30], dtype=np.int64)
    pt = np.zeros((4, 2, 1), dtype=np.int64)
    pt[:, 0, 0] = msgs << (base2k - 6)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, 34, xe, xa
    )
    acc = blind_rotation_execute_extended(m, lwe, lut, brk, block)
    glwe = GLWECiphertext(data=acc, base2k=base2k, k=lut.size * base2k)
    vals = np.asarray(
        vec_znx.decode_vec_i64(base2k, 10, dec.glwe_decrypt(m, glwe, skp).data)
    )[:, 0]
    assert np.max(np.abs(vals - msgs)) <= 1, (msgs, vals)


def test_glwe_blind_rotation_encrypted_exponent(br_ctx):
    """bdd_arithmetic/blind_rotation.rs GLWEBlindRotation: rotate a GLWE by
    an encrypted exponent, CMux per exponent bit."""
    from poulpy_tpu.binfhe import bdd as bddm
    from poulpy_tpu.hal.vec_znx import vec_znx_rotate

    m, sk_lwe, sk_glwe, skp, brk = br_ctx
    base2k = 17
    xe, xa = Source(b"\x0d" * 32), Source(b"\x0e" * 32)
    width, k_val = 3, 5
    bits = []
    for i in range(width):
        b = (k_val >> i) & 1
        pt = jnp.zeros((m.n,), jnp.int64).at[0].set(b)
        ggsw = enc.ggsw_encrypt_sk(
            m, pt, skp, base2k, 68, dnum=3, source_xe=xe, source_xa=xa
        )
        bits.append(ggsw_prepare(m, ggsw))
    kprep = bddm.FheUintPrepared(bits=bits, width=width)

    data = RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
    pt_g = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 30, 2, jnp.asarray(data)),
        base2k=base2k, k=30,
    )
    ct = enc.glwe_encrypt_sk(m, pt_g, skp, base2k, 51, xe, xa)

    for sign, rsh, mask, lsh in [(False, 0, None, 0), (True, 0, None, 0),
                                 (False, 1, 1, 2)]:
        out = bddm.glwe_blind_rotation(
            m, ct, kprep, sign=sign, bit_rsh=rsh, bit_mask=mask, bit_lsh=lsh
        )
        nbits = (width - rsh) if mask is None else mask
        amt = ((k_val >> rsh) % (1 << nbits)) << lsh
        if sign:
            amt = -amt
        want = np.asarray(vec_znx_rotate(amt, jnp.asarray(data)))
        ptd = dec.glwe_decrypt(m, out, skp)
        got = np.asarray(vec_znx.decode_vec_i64(base2k, 30, ptd.data))
        assert np.abs(got - want).max() <= 8, (sign, rsh, mask, lsh)


def test_ggsw_blind_rotation_encrypted_exponent(br_ctx):
    """GGSWBlindRotation: the rotated GGSW still acts as a valid external
    product operand: EP(ct, rot(GGSW(1))) ≈ X^k · ct."""
    from poulpy_tpu.binfhe import bdd as bddm
    from poulpy_tpu.hal.vec_znx import vec_znx_rotate

    m, sk_lwe, sk_glwe, skp, brk = br_ctx
    base2k = 17
    xe, xa = Source(b"\x0f" * 32), Source(b"\x10" * 32)
    width, k_val = 2, 3
    bits = []
    for i in range(width):
        b = (k_val >> i) & 1
        pt = jnp.zeros((m.n,), jnp.int64).at[0].set(b)
        g = enc.ggsw_encrypt_sk(
            m, pt, skp, base2k, 68, dnum=3, source_xe=xe, source_xa=xa
        )
        bits.append(ggsw_prepare(m, g))
    kprep = bddm.FheUintPrepared(bits=bits, width=width)

    one = jnp.zeros((m.n,), jnp.int64).at[0].set(1)
    ggsw1 = enc.ggsw_encrypt_sk(
        m, one, skp, base2k, 68, dnum=3, source_xe=xe, source_xa=xa
    )
    rot = bddm.ggsw_blind_rotation(m, ggsw1, kprep)

    data = RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
    pt_g = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 30, 2, jnp.asarray(data)),
        base2k=base2k, k=30,
    )
    ct = enc.glwe_encrypt_sk(m, pt_g, skp, base2k, 51, xe, xa)
    out = glwe_external_product(m, ct, ggsw_prepare(m, rot))
    want = np.asarray(vec_znx_rotate(k_val, jnp.asarray(data)))
    ptd = dec.glwe_decrypt(m, out, skp)
    got = np.asarray(vec_znx.decode_vec_i64(base2k, 30, ptd.data))
    assert np.abs(got - want).max() <= 64


def test_fheuint_identity_1w(br_ctx):
    """execute_bdd_circuit_1w_to_1w with the Identity circuit: prepared GGSW
    bits re-pack into a fresh FheUint encrypting the same value."""
    from poulpy_tpu.binfhe import bdd as bddm

    m, sk_lwe, sk_glwe, skp, brk = br_ctx
    base2k = 17
    xe, xa = Source(b"\x11" * 32), Source(b"\x12" * 32)
    width, val = 4, 11
    bits = []
    for i in range(width):
        b = (val >> i) & 1
        pt = jnp.zeros((m.n,), jnp.int64).at[0].set(b)
        g = enc.ggsw_encrypt_sk(
            m, pt, skp, base2k, 68, dnum=3, source_xe=xe, source_xa=xa
        )
        bits.append(ggsw_prepare(m, g))
    prep = bddm.FheUintPrepared(bits=bits, width=width)
    out = bddm.fheuint_op_1w(m, "identity", prep, base2k, 51)
    got = bddm.fheuint_decrypt(
        m, bddm.FheUint(glwe=out, width=width), skp
    )
    assert got == val, got


def test_xpow_table_cache_no_tracer_leak():
    """The lru-cached x-power tables are usually first built while TRACING a
    jitted caller; the cached arrays must be concrete (ensure_compile_time_
    eval), else the next differently-shaped trace dies with
    UnexpectedTracerError (regression: gate bootstrap at two batch sizes in
    one process)."""
    import jax

    from poulpy_tpu.binfhe.blind_rotation import _xpow_table
    from poulpy_tpu.hal.module import get_module

    m = get_module(32, 2)
    _xpow_table.cache_clear()

    @jax.jit
    def f(x):
        t = _xpow_table(32, m.basis.primes)
        return x + t[0, 0, 0]

    @jax.jit
    def g(x):
        t = _xpow_table(32, m.basis.primes)
        return x * 2 + t[0, 0, 0]

    f(jnp.int64(1))
    g(jnp.int64(2))  # pre-fix: UnexpectedTracerError (leaked tracer reused)


def test_circuit_bootstrap_block_extended():
    """CBT on the block-binary + extension_factor>1 blind-rotation paths
    (circuit.rs:35-99 forwards both); composes each encoding with
    block_size=4 and ext=2."""
    m = get_module(64, 4)
    src = Source(bytes(32))
    xe, xa = Source(b"\x09" * 32), Source(b"\x0a" * 32)
    base2k = 17
    n_lwe, block = 16, 4
    sk_lwe = src.binary_block(n_lwe, block)
    sk_glwe = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    cbt = circuit_bootstrapping_keygen(
        m, sk_lwe, sk_glwe, skp, base2k,
        k_brk=68, dnum_brk=4, k_atk=68, dnum_atk=4, k_tsk=68, dnum_tsk=4,
        source_xe=xe, source_xa=xa, block_size=block,
    )
    log_domain = 3
    data = RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
    pt_g = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, 30, 2, jnp.asarray(data)),
        base2k=base2k, k=30,
    )
    ct = enc.glwe_encrypt_sk(m, pt_g, skp, base2k, 51, xe, xa)

    # to_constant: GGSW(1) acts as identity in an external product
    pt = np.zeros((2, 1), dtype=np.int64)
    pt[0, 0] = 1 << (base2k - 1 - log_domain)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, 34, xe, xa
    )
    ggsw = circuit_bootstrap(
        m, lwe, log_domain, cbt, dnum_res=3, k_res=51, extension_factor=2
    )
    out = glwe_external_product(m, ct, ggsw_prepare(m, ggsw))
    got = np.asarray(vec_znx.decode_vec_i64(
        base2k, 30, dec.glwe_decrypt(m, out, skp).data))
    assert np.abs(got - data).max() <= 1024

    # to_exponent: GGSW(X^j) rotates by j
    j = 5
    pt[0, 0] = j << (base2k - 1 - log_domain)
    lwe = enc.lwe_encrypt_sk(
        None, jnp.asarray(pt), jnp.asarray(sk_lwe), base2k, 34, xe, xa
    )
    ggsw = circuit_bootstrap(
        m, lwe, log_domain, cbt, dnum_res=3, k_res=51,
        to_exponent=True, extension_factor=2,
    )
    out = glwe_external_product(m, ct, ggsw_prepare(m, ggsw))
    want = np.asarray(znx.znx_rotate(j, jnp.asarray(data)))
    got = np.asarray(vec_znx.decode_vec_i64(
        base2k, 30, dec.glwe_decrypt(m, out, skp).data))
    assert np.abs(got - want).max() <= 1024


def test_fheuint_prepare_rank_reduction_ks_glwe():
    """BDDKey.ks_glwe (bdd_arithmetic/key.rs:64-66, fhe_uint.rs
    get_bit_lwe:384-398): a rank-2-encrypted FheUint is switched down to
    the rank-1 bootstrapping key before bit extraction, then prepares and
    re-packs to the same value through the Identity circuit."""
    from poulpy_tpu.binfhe import bdd as bddm
    from poulpy_tpu.core.conversion import glwe_to_lwe_key_encrypt_sk

    m = get_module(64, 4)
    base2k = 17
    src = Source(b"\x31" * 32)
    xe, xa = Source(b"\x32" * 32), Source(b"\x33" * 32)
    n_lwe = 16
    sk_lwe = src.binary_prob((n_lwe,))
    sk1 = enc.secret_new(m, 1, src)          # bootstrapping-rank secret
    sk2 = enc.secret_new(m, 2, src)          # input ciphertext rank 2
    skp1 = glwe_secret_prepare(m, sk1)
    skp2 = glwe_secret_prepare(m, sk2)
    cbt = circuit_bootstrapping_keygen(
        m, sk_lwe, sk1, skp1, base2k,
        k_brk=68, dnum_brk=4, k_atk=68, dnum_atk=4, k_tsk=68, dnum_tsk=4,
        source_xe=xe, source_xa=xa,
    )
    ks_lwe = glwe_to_lwe_key_encrypt_sk(
        m, jnp.asarray(sk_lwe), sk1, base2k, 51, dnum=3,
        source_xe=xe, source_xa=xa,
    )
    from poulpy_tpu.core.prepared import gglwe_prepare

    ks_glwe = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, sk2, skp1, base2k, 68, dnum=3, source_xe=xe, source_xa=xa,
    ))
    key = bddm.BDDKey(
        cbt=cbt, ks_lwe=ks_lwe, n_lwe=n_lwe, base2k=base2k,
        k_ct=51, dnum_ggsw=3, k_ggsw=51, ks_glwe=ks_glwe,
    )
    width, val = 4, 13
    ct = bddm.fheuint_encrypt(m, val, width, skp2, base2k, 51, xe, xa)
    prep = bddm.fheuint_prepare(m, ct, key)
    out = bddm.fheuint_op_1w(m, "identity", prep, base2k, 51)
    got = bddm.fheuint_decrypt(m, bddm.FheUint(glwe=out, width=width), skp1)
    assert got == val, got


def _rotate_oracle(p: int, poly) -> list[int]:
    """poly · X^p in Z[X]/(X^N + 1), exact."""
    n = len(poly)
    out = [0] * n
    for i, v in enumerate(poly):
        k = (i + p) % (2 * n)
        if k < n:
            out[k] += int(v)
        else:
            out[k - n] -= int(v)
    return out


@pytest.mark.parametrize(
    "nprimes,prime_bits,batch", [(2, 30, 3), (4, 30, 1), (2, 28, 3)]
)
@pytest.mark.parametrize("block", [4, 8])
def test_block_binary_rotation_matches_oracle(nprimes, prime_bits, batch,
                                              block):
    """blind_rotation_execute_block on random keys, LUT and LWE vs an exact
    big-int replay of the block-binary CGGI recurrence: per block,
    acc += Σ_i (X^{a_i} − 1)·(acc ⊡ BRK_i), normalized once per block."""
    from oracle import align, normalize, poly_add, vmp

    from poulpy_tpu.binfhe.blind_rotation import (
        BlindRotationKeyPrepared,
        blind_rotation_execute_block,
    )
    from poulpy_tpu.binfhe.lut import LookupTable
    from poulpy_tpu.core.layouts import LWECiphertext
    from poulpy_tpu.hal import dft

    n, base2k, size, rows, psize, nblocks = 64, 17, 2, 2, 3, 2
    n_lwe = nblocks * block
    m = get_module(n, nprimes, prime_bits)
    lim = 1 << (base2k - 1)
    mats = RNG.integers(-lim, lim, size=(n_lwe, rows, 2, 2, psize, n))
    brk = BlindRotationKeyPrepared(
        pmats=dft.vmp_prepare(m, jnp.asarray(mats)), base2k=base2k,
        k=psize * base2k,
    )
    lut_data = RNG.integers(-lim, lim, size=(1, size, n))
    lut = LookupTable(data=jnp.asarray(lut_data), base2k=base2k,
                      k=size * base2k)
    lwe_data = RNG.integers(-lim, lim, size=(batch, size, n_lwe + 1))
    lwe = LWECiphertext(data=jnp.asarray(lwe_data), base2k=base2k,
                        k=size * base2k)
    have = np.asarray(blind_rotation_execute_block(m, lwe, lut, brk, block))

    two_n = 2 * n
    shift = base2k - (two_n.bit_length() - 1)   # torus → Z_2N rounding
    for b in range(batch):
        sw = [(-int(v) + (1 << (shift - 1))) >> shift for v in lwe_data[b, 0]]
        acc = [[_rotate_oracle(sw[0], lut_data[0, j]) for j in range(size)],
               [[0] * n for _ in range(size)]]
        for blk in range(nblocks):
            upd = [[[0] * n for _ in range(psize)] for _ in range(2)]
            for i in range(block):
                idx = blk * block + i
                prod = vmp(np.array(acc, dtype=np.int64), mats[idx])
                for c in range(2):
                    for j in range(psize):
                        rot = _rotate_oracle(sw[1 + idx] % two_n, prod[c][j])
                        upd[c][j] = poly_add(
                            upd[c][j], [x - y for x, y in zip(rot, prod[c][j])]
                        )
            acc = [
                normalize([poly_add(u, w) for u, w in
                           zip(upd[c], align(acc[c], psize, n))],
                          base2k, size, base2k).tolist()
                for c in range(2)
            ]
        assert have[b].tolist() == acc, b
