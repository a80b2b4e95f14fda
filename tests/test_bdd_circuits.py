"""BDD circuit-library verification: every op × widths
{4, 8, 16, 32} swept against Python int semantics through eval_bdd_plain,
plus one encrypted evaluation per op at w=4 off a shared FheUint prepare.

Reference semantics: /root/reference/poulpy-bin-fhe/src/bdd_arithmetic/
circuits/u32/*_codegen.rs (+ tests/) — RISC-V-flavored ops: shift amounts
use the low log2(width) bits of operand b; slt compares as signed
two's-complement; sra sign-fills.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from poulpy_tpu.binfhe import bdd as bddm
from poulpy_tpu.binfhe.bdd import bdd_circuit, eval_bdd_plain

RNG = np.random.default_rng(17)

OPS = [
    "add", "sub", "and", "or", "xor",
    "slt", "sltu", "sll", "srl", "sra", "identity",
]


def plain_semantics(op: str, a: int, b: int, w: int) -> int:
    """Python-int oracle for each op at width w."""
    mask = (1 << w) - 1
    logw = (w - 1).bit_length()
    amt = b & ((1 << logw) - 1)

    def signed(x):
        return x - (1 << w) if x & (1 << (w - 1)) else x

    if op == "add":
        return (a + b) & mask
    if op == "sub":
        return (a - b) & mask
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "slt":
        return 1 if signed(a) < signed(b) else 0
    if op == "sltu":
        return 1 if a < b else 0
    if op == "sll":
        return (a << amt) & mask
    if op == "srl":
        return a >> amt
    if op == "sra":
        return (signed(a) >> amt) & mask
    if op == "identity":
        return a
    raise ValueError(op)


def eval_circuit_plain(op: str, a: int, b: int, w: int) -> int:
    circuits = bdd_circuit(op, w)
    out = 0
    for j, bdd in enumerate(circuits):
        out |= eval_bdd_plain(bdd, a, b) << j
    return out


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("width", [4, 8, 16, 32])
def test_circuit_plain_sweep(op, width):
    """Exhaustive at w=4 (256 pairs), randomized (256 pairs) + structured
    corners above."""
    if width == 4:
        pairs = [(a, b) for a in range(16) for b in range(16)]
    else:
        hi = (1 << width) - 1
        corners = [0, 1, hi, hi - 1, 1 << (width - 1), (1 << (width - 1)) - 1]
        pairs = [(a, b) for a in corners for b in corners]
        pairs += [
            (int(a), int(b))
            for a, b in zip(
                RNG.integers(0, hi + 1, 256), RNG.integers(0, hi + 1, 256)
            )
        ]
    for a, b in pairs:
        want = plain_semantics(op, a, b, width)
        got = eval_circuit_plain(op, a, b, width)
        assert got == want, (op, width, a, b, got, want)


@pytest.fixture(scope="module")
def prepared_ctx():
    """One shared keygen + FheUint prepare pair for the encrypted sweep."""
    from poulpy_tpu.binfhe.circuit_bootstrapping import (
        circuit_bootstrapping_keygen,
    )
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.conversion import glwe_to_lwe_key_encrypt_sk
    from poulpy_tpu.core.prepared import glwe_secret_prepare
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    m = get_module(64, 4)
    base2k = 17
    src = Source(bytes(32))
    xe, xa = Source(b"\x0b" * 32), Source(b"\x0c" * 32)
    n_lwe = 16
    sk_lwe = src.binary_prob((n_lwe,))
    sk_glwe = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    cbt = circuit_bootstrapping_keygen(
        m, sk_lwe, sk_glwe, skp, base2k,
        k_brk=68, dnum_brk=4, k_atk=68, dnum_atk=4, k_tsk=68, dnum_tsk=4,
        source_xe=xe, source_xa=xa,
    )
    ks_lwe = glwe_to_lwe_key_encrypt_sk(
        m, jnp.asarray(sk_lwe), sk_glwe, base2k, 51, dnum=3,
        source_xe=xe, source_xa=xa,
    )
    key = bddm.BDDKey(
        cbt=cbt, ks_lwe=ks_lwe, n_lwe=n_lwe, base2k=base2k,
        k_ct=51, dnum_ggsw=3, k_ggsw=51,
    )
    width, va, vb = 4, 11, 6
    ca = bddm.fheuint_encrypt(m, va, width, skp, base2k, 51, xe, xa)
    cb = bddm.fheuint_encrypt(m, vb, width, skp, base2k, 51, xe, xa)
    pa = bddm.fheuint_prepare(m, ca, key)
    pb = bddm.fheuint_prepare(m, cb, key)
    return m, skp, pa, pb, width, va, vb


@pytest.mark.parametrize("op", OPS)
def test_circuit_encrypted_w4(prepared_ctx, op):
    m, skp, pa, pb, width, va, vb = prepared_ctx
    out = bddm.fheuint_op(m, op, pa, pb, 17, 51)
    nbits = len(bdd_circuit(op, width))
    got = bddm.fheuint_decrypt(
        m, bddm.FheUint(glwe=out, width=nbits), skp
    )
    want = plain_semantics(op, va, vb, width)
    assert got == want, (op, got, want)


def test_fheuint_prepared_encrypt_sk_debug_path():
    """The debug factory (direct constant-GGSW bit encryption, no packed
    FheUint / circuit bootstrap) drives the same BDD evaluator correctly
    (FheUintPreparedEncryptSk, fhe_uint_prepared.rs:176-225)."""
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.prepared import glwe_secret_prepare
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    m = get_module(64, 4)
    base2k, k_ct, k_ggsw, dnum = 17, 51, 51, 3
    src = Source(bytes(32))
    xe, xa = Source(b"\x0d" * 32), Source(b"\x0e" * 32)
    sk = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk)
    width, va, vb = 4, 13, 7
    pa = bddm.fheuint_prepared_encrypt_sk(
        m, va, width, skp, base2k, k_ggsw, dnum, xe, xa
    )
    pb = bddm.fheuint_prepared_encrypt_sk(
        m, vb, width, skp, base2k, k_ggsw, dnum, xe, xa
    )
    out = bddm.fheuint_op(m, "add", pa, pb, base2k, k_ct)
    got = bddm.fheuint_decrypt(
        m, bddm.FheUint(glwe=out, width=width), skp
    )
    assert got == (va + vb) % 16


def test_fheuint_prepared_crosses_jit_boundary():
    """FheUint layouts are pytree dataclasses: a prepared operand must be
    passable as a jit ARGUMENT (bench_schemes' u32-add times exactly this;
    regression for the plain-dataclass version that raised
    'non-array argument')."""
    import jax

    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.prepared import glwe_secret_prepare
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.source import Source

    m = get_module(64, 4)
    base2k, k_ct, k_ggsw, dnum = 17, 51, 51, 3
    src = Source(bytes(32))
    xe, xa = Source(b"\x0d" * 32), Source(b"\x0e" * 32)
    sk = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk)
    width, va, vb = 4, 13, 7
    pa = bddm.fheuint_prepared_encrypt_sk(
        m, va, width, skp, base2k, k_ggsw, dnum, xe, xa
    )
    pb = bddm.fheuint_prepared_encrypt_sk(
        m, vb, width, skp, base2k, k_ggsw, dnum, xe, xa
    )

    @jax.jit
    def add_op(pa_, pb_):
        return bddm.fheuint_op(m, "add", pa_, pb_, base2k, k_ct)

    out = add_op(pa, pb)
    got = bddm.fheuint_decrypt(
        m, bddm.FheUint(glwe=out, width=width), skp
    )
    assert got == (va + vb) % 16
