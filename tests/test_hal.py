"""Kernel-layer tests: NTT exactness, normalization, znx ops, encode/decode.

Oracles: exact Python big-int arithmetic (tests/oracle.py), mirroring the
reference's arbitrary-precision test strategy (SURVEY.md §4).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from poulpy_tpu.hal import dft, vec_znx, znx
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.normalization import vec_znx_normalize, vec_znx_normalize_full
from poulpy_tpu.hal.ntt import garner_lift, ntt_forward, ntt_inverse, to_mont, to_residues
from poulpy_tpu.hal.source import Source

from oracle import (
    int_to_balanced_limbs,
    limbs_to_int,
    negacyclic_mul,
    to_int64 as oracle_to_int64,
    vec_value_mod1,
)

RNG = np.random.default_rng(0)


# --------------------------------------------------------------------------
# Source
# --------------------------------------------------------------------------

def test_source_deterministic_and_branch():
    s1 = Source(bytes(32))
    s2 = Source(bytes(32))
    assert s1.next_u64() == s2.next_u64()
    a = s1.u64_array(100)
    b = s2.u64_array(100)
    assert np.array_equal(a, b)
    seed, child = s1.branch()
    assert len(seed) == 32
    # child stream differs from parent continuation
    assert child.next_u64() != s1.next_u64()


def test_source_uniform_digits_range():
    s = Source(bytes(range(32)))
    x = s.uniform_digits(17, (1000,))
    assert x.min() >= -(1 << 16) and x.max() < (1 << 16)
    # roughly centered
    assert abs(x.mean()) < (1 << 16) / 10


def test_source_normal():
    s = Source(bytes(range(32)))
    x = s.normal_f64((20000,), sigma=3.2, bound=19.2)
    assert np.abs(x).max() <= 19.2
    assert abs(np.std(x) - 3.2) < 0.1


# --------------------------------------------------------------------------
# NTT
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("nprimes", [2, 4])
def test_ntt_roundtrip(n, nprimes):
    m = get_module(n, nprimes)
    t = m.tables
    x = jnp.asarray(RNG.integers(-(2**60), 2**60, size=(3, n), dtype=np.int64))
    r = to_residues(t, x)
    back = ntt_inverse(t, ntt_forward(t, r))
    assert np.array_equal(np.asarray(back), np.asarray(r))


@pytest.mark.parametrize("n", [16, 128])
def test_ntt_negacyclic_product_exact(n):
    """NTT pointwise product + Garner lift == exact big-int negacyclic mul."""
    m = get_module(n, 4)
    t = m.tables
    a = RNG.integers(-(2**25), 2**25, size=n, dtype=np.int64)
    b = RNG.integers(-(2**25), 2**25, size=n, dtype=np.int64)
    want = negacyclic_mul([int(v) for v in a], [int(v) for v in b])
    a_dft = ntt_forward(t, to_residues(t, jnp.asarray(a)))
    b_mont = to_mont(t, ntt_forward(t, to_residues(t, jnp.asarray(b))))
    from poulpy_tpu.hal.ntt import mont_mul

    prod = mont_mul(a_dft, b_mont, t.p[:, None], t.qinv[:, None])
    have = np.asarray(garner_lift(t, ntt_inverse(t, prod)))
    assert [int(v) for v in have] == want


def test_garner_lift_centered():
    m = get_module(16, 4)
    t = m.tables
    vals = jnp.asarray(
        RNG.integers(-(2**62), 2**62, size=(5, 16), dtype=np.int64)
    )
    r = to_residues(t, vals)
    back = garner_lift(t, r)
    assert np.array_equal(np.asarray(back), np.asarray(vals))


# --------------------------------------------------------------------------
# znx ops
# --------------------------------------------------------------------------

def test_rotate_matches_naive():
    n = 16
    a = RNG.integers(-100, 100, size=n, dtype=np.int64)
    for p in [0, 1, 5, n - 1, n, n + 3, 2 * n - 1, -1, -7, -n, 3 * n + 2]:
        have = np.asarray(znx.znx_rotate(p, jnp.asarray(a)))
        want = np.zeros(n, dtype=np.int64)
        for i, ai in enumerate(a):  # a_i X^i · X^p
            k = (i + p) % (2 * n)
            if k < n:
                want[k] += ai
            else:
                want[k - n] -= ai
        assert np.array_equal(have, want), p


def test_rotate_batched_traced():
    n = 16
    a = RNG.integers(-100, 100, size=(4, n), dtype=np.int64)
    ps = np.array([1, 5, -3, 17], dtype=np.int64)
    have = np.asarray(znx.znx_rotate(jnp.asarray(ps), jnp.asarray(a)))
    for b in range(4):
        want = np.asarray(znx.znx_rotate(int(ps[b]), jnp.asarray(a[b])))
        assert np.array_equal(have[b], want)


def test_automorphism_matches_naive():
    n = 16
    a = RNG.integers(-100, 100, size=n, dtype=np.int64)
    for p in [1, 3, 5, 7, 15, 31, 2 * n - 1]:
        have = np.asarray(znx.znx_automorphism(p, jnp.asarray(a)))
        want = np.zeros(n, dtype=np.int64)
        for i, ai in enumerate(a):  # a_i X^i -> a_i X^{i·p}
            k = (i * p) % (2 * n)
            if k < n:
                want[k] += ai
            else:
                want[k - n] -= ai
        assert np.array_equal(have, want), p


def test_automorphism_composes_with_rotate():
    # φ_p(a · X^t) = φ_p(a) · X^{t·p}
    n = 32
    a = jnp.asarray(RNG.integers(-100, 100, size=n, dtype=np.int64))
    p, tshift = 5, 3
    lhs = znx.znx_automorphism(p, znx.znx_rotate(tshift, a))
    rhs = znx.znx_rotate(tshift * p, znx.znx_automorphism(p, a))
    assert np.array_equal(np.asarray(lhs), np.asarray(rhs))


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base2k", [5, 17, 22])
@pytest.mark.parametrize("size", [1, 3, 6])
def test_normalize_preserves_value_and_balances(base2k, size):
    n = 8
    a = RNG.integers(-(2**55), 2**55, size=(size, n), dtype=np.int64)
    have = np.asarray(vec_znx_normalize(base2k, jnp.asarray(a)))
    # digits balanced
    half = 1 << (base2k - 1)
    assert have.min() >= -half and have.max() < half
    # value preserved mod 1
    assert vec_value_mod1(have, base2k) == vec_value_mod1(a, base2k)


@pytest.mark.parametrize("offset", [0, 3, 17, 40, -3, -17, -40])
def test_normalize_full_offset(offset):
    base2k, size, n = 17, 4, 8
    a = RNG.integers(-(2**40), 2**40, size=(size, n), dtype=np.int64)
    have = np.asarray(
        vec_znx_normalize_full(size, base2k, offset, jnp.asarray(a), base2k)
    )
    half = 1 << (base2k - 1)
    assert have.min() >= -half and have.max() < half
    tot = size * base2k
    mod = 1 << tot
    # the shift applies to the concrete (uncentered) limb composition — a
    # right shift on the torus depends on the representative, exactly as in
    # the reference's rsh (vec_znx/shift.rs operates on raw limbs)
    want_vals = limbs_to_int(a, base2k)
    have_vals = vec_value_mod1(have, base2k)
    for hv, wv in zip(have_vals, want_vals):
        shifted = (wv * (1 << offset)) if offset >= 0 else (wv >> (-offset))
        diff = (hv - shifted) % mod
        diff = min(diff, mod - diff)
        assert diff <= size + 1, (hv, wv, offset)


@pytest.mark.parametrize("kr,ka", [(17, 22), (22, 17), (13, 26)])
@pytest.mark.parametrize("res_size,a_size", [(4, 4), (3, 5), (6, 3)])
def test_normalize_full_cross_base(kr, ka, res_size, a_size):
    n = 8
    a = RNG.integers(-(2**40), 2**40, size=(a_size, n), dtype=np.int64)
    have = np.asarray(
        vec_znx_normalize_full(res_size, kr, 0, jnp.asarray(a), ka)
    )
    half = 1 << (kr - 1)
    assert have.min() >= -half and have.max() < half
    # compare torus values as fractions with tolerance 2^{-res_tot+4}
    a_vals = vec_value_mod1(a, ka)
    h_vals = vec_value_mod1(have, kr)
    a_tot = a_size * ka
    r_tot = res_size * kr
    for hv, av in zip(h_vals, a_vals):
        # compare hv/2^r_tot vs av/2^a_tot mod 1
        lcm_tot = max(a_tot, r_tot)
        d = (hv << (lcm_tot - r_tot)) - (av << (lcm_tot - a_tot))
        d %= 1 << lcm_tot
        d = min(d, (1 << lcm_tot) - d)
        assert d <= (1 << max(0, lcm_tot - min(a_tot, r_tot) + 4)), (hv, av)


# --------------------------------------------------------------------------
# encode / decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base2k,k", [(17, 34), (17, 51), (22, 30), (17, 10)])
def test_encode_decode_roundtrip(base2k, k):
    n = 16
    size = 4
    lim = 1 << min(k - 1, 40)
    data = RNG.integers(-lim, lim, size=n, dtype=np.int64)
    enc = vec_znx.encode_vec_i64(base2k, k, size, jnp.asarray(data))
    half = 1 << (base2k - 1)
    e = np.asarray(enc)
    assert e.min() >= -half and e.max() < half
    dec = np.asarray(vec_znx.decode_vec_i64(base2k, k, enc))
    assert np.array_equal(dec, data)


def test_lsh_rsh_inverse():
    base2k, size, n, k = 17, 5, 8, 13
    data = RNG.integers(-(2**30), 2**30, size=n, dtype=np.int64)
    enc = vec_znx.encode_vec_i64(base2k, 60, size, jnp.asarray(data))
    up = vec_znx.vec_znx_lsh(base2k, k, enc)
    back = vec_znx.vec_znx_rsh(base2k, k, up)
    dec = np.asarray(vec_znx.decode_vec_i64(base2k, 60, back))
    assert np.max(np.abs(dec - data)) <= 1


# --------------------------------------------------------------------------
# DFT-layer ops
# --------------------------------------------------------------------------

def test_svp_apply_exact():
    n, size, base2k = 32, 3, 17
    m = get_module(n, 4)
    a = RNG.integers(-(2**16), 2**16, size=(size, n), dtype=np.int64)
    s = RNG.integers(-1, 2, size=n, dtype=np.int64)
    a_dft = dft.dft_apply(m, jnp.asarray(a))
    s_p = dft.svp_prepare(m, jnp.asarray(s))
    prod = dft.svp_apply(m, a_dft, s_p)
    big = np.asarray(dft.idft_apply(m, prod))
    for j in range(size):
        want = negacyclic_mul([int(v) for v in a[j]], [int(v) for v in s])
        assert [int(v) for v in big[j]] == want


def test_vmp_apply_exact():
    n, base2k = 16, 17
    rows, cols_in, cols_out, size = 3, 2, 2, 4
    m = get_module(n, 4)
    a = RNG.integers(-(2**16), 2**16, size=(cols_in, size, n), dtype=np.int64)
    mat = RNG.integers(
        -(2**16), 2**16, size=(rows, cols_in, cols_out, size, n), dtype=np.int64
    )
    a_dft = dft.dft_apply(m, jnp.asarray(a))
    pmat = dft.vmp_prepare(m, jnp.asarray(mat))
    res = dft.vmp_apply(m, a_dft, pmat)
    big = np.asarray(dft.idft_apply(m, res))
    rmax = min(rows, size)
    for co in range(cols_out):
        for j in range(size):
            want = [0] * n
            for ci in range(cols_in):
                for r in range(rmax):
                    t = negacyclic_mul(
                        [int(v) for v in a[ci, r]],
                        [int(v) for v in mat[r, ci, co, j]],
                    )
                    want = [x + y for x, y in zip(want, t)]
            assert [int(v) for v in big[co, j]] == want, (co, j)


def test_vmp_apply_limb_offset():
    n = 16
    rows, cols_in, cols_out, size = 2, 1, 1, 4
    m = get_module(n, 4)
    a = RNG.integers(-(2**10), 2**10, size=(cols_in, size, n), dtype=np.int64)
    mat = RNG.integers(
        -(2**10), 2**10, size=(rows, cols_in, cols_out, size, n), dtype=np.int64
    )
    a_dft = dft.dft_apply(m, jnp.asarray(a))
    pmat = dft.vmp_prepare(m, jnp.asarray(mat))
    res0 = np.asarray(dft.idft_apply(m, dft.vmp_apply(m, a_dft, pmat, limb_offset=0)))
    res1 = np.asarray(dft.idft_apply(m, dft.vmp_apply(m, a_dft, pmat, limb_offset=1)))
    # limb_offset=1 drops output limb 0 and shifts the window
    assert np.array_equal(res1[:, :-1], res0[:, 1:])
    assert np.all(res1[:, -1] == 0)


def test_cnv_apply_exact():
    n, sa, sb = 16, 3, 2
    m = get_module(n, 4)
    a = RNG.integers(-(2**16), 2**16, size=(sa, n), dtype=np.int64)
    b = RNG.integers(-(2**16), 2**16, size=(sb, n), dtype=np.int64)
    ap = dft.cnv_prepare_left(m, jnp.asarray(a))
    bp = dft.cnv_prepare_right(m, jnp.asarray(b))
    res = np.asarray(dft.idft_apply(m, dft.cnv_apply(m, ap, bp, sa + sb - 1)))
    for k in range(sa + sb - 1):
        want = [0] * n
        for i in range(sa):
            j = k - i
            if 0 <= j < sb:
                t = negacyclic_mul([int(v) for v in a[i]], [int(v) for v in b[j]])
                want = [x + y for x, y in zip(want, t)]
        assert [int(v) for v in res[k]] == want


def test_dft_apply_step_offset():
    n, size = 16, 7
    m = get_module(n, 2)
    a = jnp.asarray(RNG.integers(-100, 100, size=(size, n), dtype=np.int64))
    full = dft.dft_apply(m, a)
    sub = dft.dft_apply(m, a, step=3, offset=1)
    assert sub.shape[-3] == 3
    assert np.array_equal(np.asarray(sub[0]), np.asarray(full[1]))
    assert np.array_equal(np.asarray(sub[1]), np.asarray(full[4]))
    # limb offset+2·step = 7 ≥ a_size → zeroed (vec_znx_dft.rs:185-188)
    assert np.all(np.asarray(sub[2]) == 0)


def test_chacha_core_openssl_kat():
    """Known-answer anchor for the ChaCha permutation core: the SAME
    quarter-round/layout/feed-forward code run at 10 double-rounds must
    reproduce OpenSSL's ChaCha20 (via pyca `cryptography`) byte-for-byte —
    an external, independently-validated implementation, so the Python and
    C++ twins cannot share a hidden core bug."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    from poulpy_tpu.hal.source import _chacha_blocks

    rng = np.random.default_rng(42)
    for _ in range(3):
        key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        ctr0 = int(rng.integers(0, 2**31))
        nblocks = 5
        # pyca nonce = 4-byte LE initial counter || 12-byte nonce; our
        # layout word12 = ctr lo, word13..15 = 0
        nonce = ctr0.to_bytes(4, "little") + bytes(12)
        ks = (
            Cipher(algorithms.ChaCha20(key, nonce), mode=None)
            .encryptor()
            .update(bytes(64 * nblocks))
        )
        kw = np.frombuffer(key, np.uint8).view(np.uint32)
        counters = np.arange(ctr0, ctr0 + nblocks, dtype=np.uint64)
        assert _chacha_blocks(kw, counters, double_rounds=10).tobytes() == ks


def test_chacha8_keystream_pinned():
    """ChaCha8 keystream for the all-zero key matches the published
    eSTREAM/ECRYPT ChaCha8 test vector (set 1 vector 0 keystream prefix) —
    pins the 4-double-round count and rand_chacha-compatible layout
    (poulpy-hal/src/source.rs:18-30 wraps ChaCha8Rng)."""
    from poulpy_tpu.hal.source import _chacha_blocks

    out = _chacha_blocks(np.zeros(8, np.uint32), np.array([0], np.uint64))
    want = bytes.fromhex(
        "3e00ef2f895f40d67f5bb8e81f09a5a12c840ec3ce9a7f3b181be188ef711a1e"
    )
    assert out.tobytes()[:32] == want
    # Source consumes this keystream directly: next_u64 = word0 | word1<<32
    s = Source(bytes(32))
    w = np.frombuffer(want, np.uint8).view(np.uint32)
    assert s.next_u64() == int(w[0]) | (int(w[1]) << 32)
    assert s.next_u64() == int(w[2]) | (int(w[3]) << 32)


_VMP_SWEEP_COMBOS = [
    (2, 2, 2, 4, 2, 2),   # rows < size_a: extra input limbs ignored
    (4, 1, 1, 2, 3, 3),   # rows > size_a: extra gadget rows unused
    (3, 2, 3, 3, 4, 2),   # res_size < psize: output window truncated
    (2, 1, 2, 2, 2, 4),   # res_size > psize: zero-padded tail
]
_VMP_SWEEP_COMBOS_EXTRA = [
    (1, 1, 1, 1, 1, 1),   # degenerate minimum
    (1, 2, 1, 3, 2, 2),
    (2, 1, 2, 1, 3, 3),
]


@pytest.mark.parametrize(
    "combos",
    [
        _VMP_SWEEP_COMBOS,
        pytest.param(_VMP_SWEEP_COMBOS_EXTRA, marks=pytest.mark.slow),
    ],
    ids=["edge", "extra"],
)
def test_vmp_apply_shape_sweep(combos):
    """(rows, cols_in, cols_out, size_a, psize, res_size) sweep against the
    exact oracle — the reference's primary VMP test iterates all shape
    combinations the same way (poulpy-hal/src/test_suite/vmp.rs:21-110),
    covering rows<size, rows>size, res_size<psize and res_size>psize.
    The default keeps the four edge-behavior combos; plain square-ish shapes
    (already covered by test_vmp_apply_exact) run under -m slow."""
    n = 16
    m = get_module(n, 4)
    rng = np.random.default_rng(42)
    for rows, cols_in, cols_out, size_a, psize, res_size in combos:
        a = rng.integers(-(2**16), 2**16, size=(cols_in, size_a, n),
                         dtype=np.int64)
        mat = rng.integers(
            -(2**16), 2**16,
            size=(rows, cols_in, cols_out, psize, n), dtype=np.int64,
        )
        a_dft = dft.dft_apply(m, jnp.asarray(a))
        pmat = dft.vmp_prepare(m, jnp.asarray(mat))
        big = np.asarray(dft.idft_apply(
            m, dft.vmp_apply(m, a_dft, pmat, res_size=res_size)
        ))
        assert big.shape == (cols_out, res_size, n)
        rmax = min(rows, size_a)
        for co in range(cols_out):
            for j in range(res_size):
                want = [0] * n
                if j < psize:
                    for ci in range(cols_in):
                        for r in range(rmax):
                            t = negacyclic_mul(
                                [int(v) for v in a[ci, r]],
                                [int(v) for v in mat[r, ci, co, j]],
                            )
                            want = [x + y for x, y in zip(want, t)]
                key = (rows, cols_in, cols_out, size_a, psize, res_size)
                assert [int(v) for v in big[co, j]] == want, (key, co, j)


# --------------------------------------------------------------------------
# Modular primitives and the residue exit, against Python ints
# --------------------------------------------------------------------------

PRIME_LIST = [268369921, 268361729,       # 28-bit
              1073479681, 1072693249]     # 30-bit


def _consts(p):
    from poulpy_tpu.hal.primes import R

    qinv = (-pow(p, -1, R)) % R
    return R, qinv, R * R % p


@pytest.mark.parametrize("p", PRIME_LIST)
def test_mont_mul_exact(p):
    """REDC(a·b) = a·b·R^{-1} mod p in [0, p), edge values included."""
    from poulpy_tpu.hal.ntt import mont_mul

    R, qinv, _ = _consts(p)
    a = RNG.integers(0, p, size=4096, dtype=np.int64)
    b = RNG.integers(0, p, size=4096, dtype=np.int64)
    a[:4], b[:4] = [0, 1, p - 1, p - 1], [0, 1, 1, p - 1]
    have = np.asarray(mont_mul(jnp.asarray(a), jnp.asarray(b),
                               jnp.int64(p), jnp.int64(qinv)))
    r_inv = pow(R, -1, p)
    want = [int(x) * int(y) * r_inv % p for x, y in zip(a, b)]
    assert have.tolist() == want


@pytest.mark.parametrize("p", PRIME_LIST)
def test_reduce_i64_exact(p):
    """Any signed int64 → its residue mod p, including both int64 ends."""
    from poulpy_tpu.hal.ntt import reduce_i64

    _, qinv, r2 = _consts(p)
    x = RNG.integers(-(2**63), 2**63 - 1, size=4096, dtype=np.int64)
    x[:6] = [0, -1, 1, -(2**63), 2**63 - 1, p]
    have = np.asarray(reduce_i64(jnp.asarray(x), jnp.int64(p),
                                 jnp.int64(qinv), jnp.int64(r2),
                                 jnp.int64((1 << 40) % p)))
    assert have.tolist() == [int(v) % p for v in x]


@pytest.mark.parametrize("p", PRIME_LIST)
def test_fold_mod_exact(p):
    """Non-negative accumulators below 2^59 → value mod p."""
    from poulpy_tpu.hal.ntt import fold_mod

    _, qinv, r2 = _consts(p)
    acc = RNG.integers(0, 2**59, size=4096, dtype=np.int64)
    acc[:3] = [0, 2**59 - 1, p]
    have = np.asarray(fold_mod(jnp.asarray(acc), jnp.int64(p),
                               jnp.int64(qinv), jnp.int64(r2)))
    assert have.tolist() == [int(v) % p for v in acc]


@pytest.mark.parametrize(
    "primes", [PRIME_LIST[:2], PRIME_LIST[2:], PRIME_LIST],
    ids=["28bit", "30bit", "mixed4"],
)
def test_garner_lift_matches_crt(primes):
    """Centered CRT lift of arbitrary residues, wrapped to int64."""
    from poulpy_tpu.hal.ntt import NttTables
    from poulpy_tpu.hal.primes import PrimeBasis

    basis = PrimeBasis(tuple(primes))
    t = NttTables(basis, 16)
    r = np.stack([RNG.integers(0, p, size=(3, 16)) for p in primes], axis=-2)
    r[0, :, 0] = 0
    r[0, :, 1] = [p - 1 for p in primes]
    have = np.asarray(garner_lift(t, jnp.asarray(r)))
    M = basis.modulus
    for b in range(3):
        for c in range(16):
            v = sum(int(r[b, i, c]) * (M // p) * pow(M // p, -1, p)
                    for i, p in enumerate(primes)) % M
            v = v - M if v > M // 2 else v
            assert int(have[b, c]) == oracle_to_int64(v), (b, c)


@pytest.mark.parametrize("nprimes", [2, 4])
@pytest.mark.parametrize(
    "psize,res_size,kr,ka,offset,s_size",
    [
        (4, 3, 17, 17, 0, 0),
        (4, 3, 17, 17, 0, 3),
        (3, 5, 13, 19, 0, 0),
        (2, 2, 17, 17, -5, 0),
        (5, 2, 21, 17, 4, 2),
    ],
)
def test_residue_exit_matches_oracle(nprimes, psize, res_size, kr, ka,
                                     offset, s_size):
    """The exit of every product: arbitrary residues → Garner lift into the
    int64 big accumulator (+ an int64 add on the leading limbs) → carry
    normalization with base change, resize and offset."""
    from oracle import normalize

    n = 16
    m = get_module(n, nprimes)
    primes = m.basis.primes
    x = np.stack([RNG.integers(0, p, size=(2, psize, n)) for p in primes],
                 axis=-2)
    big = garner_lift(m.tables, jnp.asarray(x))
    small = RNG.integers(-(2**20), 2**20, size=(2, max(s_size, 1), n),
                         dtype=np.int64)
    if s_size:
        upto = min(s_size, psize)
        big = big.at[..., :upto, :].add(jnp.asarray(small[:, :upto]))
    have = np.asarray(vec_znx_normalize_full(res_size, kr, offset, big, ka))
    M = m.basis.modulus
    for b in range(2):
        vals = []
        for j in range(psize):
            row = []
            for c in range(n):
                v = sum(int(x[b, j, i, c]) * (M // p) * pow(M // p, -1, p)
                        for i, p in enumerate(primes)) % M
                v = v - M if v > M // 2 else v
                if j < min(s_size, psize):
                    v += int(small[b, j, c])
                row.append(oracle_to_int64(v))
            vals.append(row)
        want = normalize(vals, ka, res_size, kr, offset)
        assert np.array_equal(have[b], want), b
