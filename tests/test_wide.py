"""Wide (i128-twin) big-accumulator mode tests (hal/wide.py).

The reference's NTT120 backends carry exact i128 accumulators
(poulpy-cpu-ref/src/ntt120/module.rs:45-46) enabling base2k ≈ 52 parameter
sets like the CKKS demo (poulpy-ckks/examples/poly2.rs:48-61).  Oracles here
are exact Python big ints (tests/oracle.py pattern, SURVEY.md §4).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from poulpy_tpu.hal import dft, wide
from poulpy_tpu.hal.module import get_module

RNG = np.random.default_rng(23)


def _pair_to_int(hi, lo):
    return (np.asarray(hi).astype(object) << 64) + (
        np.asarray(lo).astype(np.uint64).astype(object)
    )


def _rand_residues(basis, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, p in enumerate(basis.primes):
        out[..., i, :] = RNG.integers(0, p, size=shape[:-2] + shape[-1:])
    return jnp.asarray(out)


@pytest.mark.parametrize("nprimes", [2, 4])
def test_garner_lift_wide_exact(nprimes):
    n = 64
    m = get_module(n, nprimes)
    basis = m.basis
    r = _rand_residues(basis, (3, nprimes, n))
    hi, lo = wide.garner_lift_wide(m.tables, r)
    got = _pair_to_int(hi, lo)
    rnp = np.asarray(r)
    M = basis.modulus
    for b in range(3):
        for c in range(n):
            # exact centered CRT value
            v = 0
            for i, p in enumerate(basis.primes):
                Mi = M // p
                v = (v + int(rnp[b, i, c]) * Mi * pow(Mi, -1, p)) % M
            if v > M // 2:
                v -= M
            assert got[b, c] == v, (b, c)


def test_wide_normalize_matches_i64_path():
    """For values that fit int64, the wide path is bit-identical."""
    a = jnp.asarray(
        RNG.integers(-(2**60), 2**60, size=(4, 5, 64), dtype=np.int64)
    )
    for res_size, kr, ka, off in [(3, 17, 17, 0), (5, 13, 19, -4), (2, 21, 17, 3)]:
        want = dft.big_normalize(None, res_size, kr, a, ka, res_offset=off)
        have = dft.big_normalize_wide(
            None, res_size, kr, wide.wfrom_i64(a), ka, res_offset=off
        )
        assert np.array_equal(np.asarray(have), np.asarray(want)), (kr, ka)


def test_wide_normalize_oracle_beyond_i64():
    """128-bit limb values → balanced digits, vs exact big-int oracle."""
    n = 32
    a_size, res_size, kr, ka, off = 2, 3, 52, 52, -7
    vals = [
        [int(RNG.integers(-(2**62), 2**62)) * int(RNG.integers(0, 2**50))
         for _ in range(n)]
        for _ in range(a_size)
    ]
    hi = jnp.asarray(
        [[wide.i64c(v >> 64) for v in row] for row in vals], dtype=jnp.int64
    )[:, None, :].reshape(a_size, n)[None]
    lo = jnp.asarray(
        [[wide.i64c(v) for v in row] for row in vals], dtype=jnp.int64
    ).reshape(a_size, n)[None]
    got = np.asarray(
        dft.big_normalize_wide(None, res_size, kr, (hi, lo), ka, res_offset=off)
    )[0]

    # oracle: total = Σ_j floor(v_j · 2^{res_size·kr − (j+1)·ka + off}),
    # balanced base-2^kr digits of total mod 2^{res_size·kr}
    mod = 1 << (res_size * kr)
    half = 1 << (kr - 1)
    for c in range(n):
        total = 0
        for j in range(a_size):
            t = res_size * kr - (j + 1) * ka + off
            v = vals[j][c]
            total += v << t if t >= 0 else v >> (-t)
        total %= mod
        digits = []
        for _ in range(res_size):
            d = ((total + half) % (1 << kr)) - half
            digits.append(d)
            total = (total - d) >> kr
        digits.reverse()  # limb 0 most significant
        for i in range(res_size):
            assert int(got[i, c]) == digits[i], (c, i)


def test_keyswitch_wide_roundtrip():
    """GLWE keyswitch at base2k = 44 (exact values ≫ int64) decrypts right."""
    from poulpy_tpu.core import decryption as dec
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.keyswitching import glwe_keyswitch
    from poulpy_tpu.core.layouts import GLWEPlaintext
    from poulpy_tpu.core.prepared import gglwe_prepare, glwe_secret_prepare
    from poulpy_tpu.hal import vec_znx
    from poulpy_tpu.hal.source import Source

    n, base2k, k_ct, k_key, k_pt = 64, 44, 88, 132, 44
    m = get_module(n, 4)
    bits = dft.product_bits(base2k, base2k, m.log_n, 3 * 1)
    assert dft.needs_wide(bits)
    sk1 = enc.secret_new(m, 1, Source(b"\x01" * 32), dist="ternary_hw", hw=16)
    sk2 = enc.secret_new(m, 1, Source(b"\x02" * 32), dist="ternary_hw", hw=16)
    sk2p = glwe_secret_prepare(m, sk2)
    data = RNG.integers(-(2**20), 2**20, n, dtype=np.int64)
    pt = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(base2k, k_pt, 2, jnp.asarray(data)),
        base2k=base2k, k=k_pt,
    )
    ct = enc.glwe_encrypt_sk(
        m, pt, glwe_secret_prepare(m, sk1), base2k, k_ct,
        Source(b"\x03" * 32), Source(b"\x04" * 32),
    )
    ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, sk1, sk2p, base2k, k_key, dnum=3,
        source_xe=Source(b"\x05" * 32), source_xa=Source(b"\x06" * 32),
    ))
    out = glwe_keyswitch(m, ct, ksk)
    got = np.asarray(vec_znx.decode_vec_i64(
        base2k, k_pt, dec.glwe_decrypt(m, out, sk2p).data
    ))
    assert np.abs(got - data).max() <= 2


def test_ckks_mul_reference_demo_params():
    """CKKS ct×ct at the reference demo parameterization (base2k=52, k=95,
    log_delta=30 — poulpy-ckks/examples/poly2.rs:48-61, NTT120 backend),
    which requires the wide accumulator path."""
    from poulpy_tpu.ckks import ops as ck
    from poulpy_tpu.ckks.encoder import Encoder
    from poulpy_tpu.core import encryption as enc
    from poulpy_tpu.core.prepared import (
        glwe_secret_prepare,
        glwe_tensor_key_prepare,
    )
    from poulpy_tpu.hal.source import Source

    n, base2k, k_ct, k_key = 64, 52, 95, 156
    log_delta, log_budget = 30, 35
    m = get_module(n, 4)
    sk = enc.secret_new(m, 1, Source(bytes(32)), dist="ternary_hw", hw=16)
    skp = glwe_secret_prepare(m, sk)
    tsk = glwe_tensor_key_prepare(
        m,
        enc.glwe_tensor_key_encrypt_sk(
            m, sk, skp, base2k, k_key, dnum=2,
            source_xe=Source(b"\x01" * 32), source_xa=Source(b"\x02" * 32),
        ),
    )
    encd = Encoder(n)
    z1 = RNG.normal(size=n // 2) + 1j * RNG.normal(size=n // 2)
    z2 = RNG.normal(size=n // 2) + 1j * RNG.normal(size=n // 2)
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    c1 = ck.encrypt_sk(
        m, ck.encode(encd, z1, base2k, k_ct, log_delta, log_budget),
        skp, k_ct, xe, xa,
    )
    c2 = ck.encrypt_sk(
        m, ck.encode(encd, z2, base2k, k_ct, log_delta, log_budget),
        skp, k_ct, xe, xa,
    )
    got = ck.decode(encd, ck.decrypt(m, ck.mul(m, c1, c2, tsk), skp))
    assert np.abs(got - z1 * z2).max() < 1e-3


# ---------------------------------------------------------------------------
# Wide product and tensor pipelines vs exact big-int oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "ci,co,rows,size_a,psize,kr,ka,s_size,offset,batch",
    [
        (1, 2, 2, 2, 3, 52, 52, 0, 0, 3),    # relinearize shape
        (1, 2, 2, 2, 3, 52, 52, 3, 0, 2),    # + per-column small
        (2, 2, 3, 3, 4, 44, 44, 0, 0, 1),    # external product shape
        (1, 2, 3, 3, 3, 52, 52, 2, -7, 2),   # landing offset
        (2, 2, 2, 2, 3, 26, 52, 0, 5, 2),    # kr < 32 output windows
    ],
)
def test_wide_product_matches_oracle(ci, co, rows, size_a, psize, kr, ka,
                                     s_size, offset, batch):
    """dft → vmp → wide (hi, lo) Garner exit → + int64 small → wide
    normalization, at limb values far beyond int64."""
    from oracle import normalize, poly_add, vmp

    from poulpy_tpu.hal.wide import wadd, wfrom_i64

    n, res_size = 64, 3
    m = get_module(n, 5, 28)
    lim = 1 << (ka - 1)
    a = RNG.integers(-lim, lim, size=(batch, ci, size_a, n), dtype=np.int64)
    mat = RNG.integers(-lim, lim, size=(rows, ci, co, psize, n),
                       dtype=np.int64)
    small = RNG.integers(-lim, lim, size=(batch, co, max(s_size, 1), n),
                         dtype=np.int64)
    res_dft = dft.vmp_apply(m, dft.dft_apply(m, jnp.asarray(a)),
                            dft.vmp_prepare(m, jnp.asarray(mat)))
    hi, lo = dft.idft_apply_wide(m, res_dft)
    upto = min(s_size, psize)
    if s_size:
        sh, sl = wfrom_i64(jnp.asarray(small[..., :upto, :]))
        nh, nl = wadd(hi[..., :upto, :], lo[..., :upto, :], sh, sl)
        hi = hi.at[..., :upto, :].set(nh)
        lo = lo.at[..., :upto, :].set(nl)
    have = np.asarray(dft.big_normalize_wide(
        m, res_size, kr, (hi, lo), ka, res_offset=offset
    ))
    for b in range(batch):
        big = vmp(a[b], mat)
        for c in range(co):
            for j in range(upto):
                big[c][j] = poly_add(big[c][j], small[b, c, j].tolist())
            want = normalize(big[c], ka, res_size, kr, offset)
            assert np.array_equal(have[b, c], want), (b, c)


@pytest.mark.parametrize(
    "size_a,size_b,dnum,lin_size,kr,ka,offset",
    [
        (2, 2, 2, 3, 52, 52, 0),
        (2, 3, 3, 3, 52, 52, -9),
        (3, 3, 2, 4, 44, 52, 13),
    ],
)
def test_wide_tensor_matches_oracle(size_a, size_b, dnum, lin_size, kr, ka,
                                    offset):
    """Rank-1 tensor product through the wide exit: the quadratic term
    normalized into gadget digits and the linear terms normalized with the
    landing offset, vs the exact limb convolution."""
    from oracle import limb_conv, normalize, poly_add

    from poulpy_tpu.core.layouts import GLWECiphertext
    from poulpy_tpu.core.operations import glwe_tensor_product_big

    n, batch = 64, 2
    m = get_module(n, 5, 28)
    conv_size = size_a + size_b - 1
    lim = 1 << (ka - 1)
    a = RNG.integers(-lim, lim, size=(batch, 2, size_a, n), dtype=np.int64)
    b = RNG.integers(-lim, lim, size=(batch, 2, size_b, n), dtype=np.int64)
    lin, quad = glwe_tensor_product_big(
        m, GLWECiphertext(data=jnp.asarray(a), base2k=ka, k=size_a * ka),
        GLWECiphertext(data=jnp.asarray(b), base2k=ka, k=size_b * ka),
        conv_size, wide=True,
    )
    have_d = np.asarray(dft.big_normalize_wide(
        m, dnum, kr, quad[(0, 0)], ka, res_offset=offset))
    have_lin = [np.asarray(dft.big_normalize_wide(
        m, lin_size, ka, t, ka, res_offset=offset)) for t in lin]
    for i in range(batch):
        def conv(x, y):
            return limb_conv(a[i, x], b[i, y], conv_size)

        want_lin = [conv(0, 0), [poly_add(u, v) for u, v in
                                 zip(conv(0, 1), conv(1, 0))]]
        assert np.array_equal(
            have_d[i], normalize(conv(1, 1), ka, dnum, kr, offset)), i
        for c in range(2):
            assert np.array_equal(
                have_lin[c][i],
                normalize(want_lin[c], ka, lin_size, ka, offset)), (i, c)
