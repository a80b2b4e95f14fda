"""Native C++ kernel library vs the numpy/jnp reference implementations.

Third-backend cross-check (the cross_backend_test_suite pattern,
poulpy-hal/src/test_suite/mod.rs:35-95): every native kernel must be
bit-exact against the Python implementation it accelerates.  Skipped
wholesale when no C++ toolchain is available (native.available() False).
"""

import numpy as np
import pytest

from poulpy_tpu import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no native toolchain"
)

RNG = np.random.default_rng(41)


def test_chacha8_blocks_matches_numpy():
    from poulpy_tpu.hal.source import _chacha_blocks

    key = RNG.integers(0, 1 << 32, size=8, dtype=np.uint32)
    for counter0, nblocks in [(0, 1), (0, 7), (12345, 4), (2**33, 3)]:
        counters = np.arange(counter0, counter0 + nblocks, dtype=np.uint64)
        want = _chacha_blocks(key, counters)
        have = native.chacha8_blocks(key, counter0, nblocks)
        np.testing.assert_array_equal(have, want)


def test_source_stream_unchanged_by_native_path():
    """The Source keystream is identical with and without the native
    refill (same draws, same branch seeds)."""
    from poulpy_tpu.hal import source as src_mod

    s1 = src_mod.Source(b"\x07" * 32)
    draws1 = [s1.next_u64() for _ in range(100)]
    tern1 = s1.ternary_hw(64, 16)

    native._lib.cache_clear()
    import os

    os.environ["POULPY_NATIVE"] = "0"
    try:
        s2 = src_mod.Source(b"\x07" * 32)
        draws2 = [s2.next_u64() for _ in range(100)]
        tern2 = s2.ternary_hw(64, 16)
    finally:
        del os.environ["POULPY_NATIVE"]
        native._lib.cache_clear()
    assert draws1 == draws2
    np.testing.assert_array_equal(tern1, tern2)


def test_znx_rotate_matches_hal():
    from poulpy_tpu.hal.znx import znx_rotate

    a = RNG.integers(-(2**40), 2**40, size=(3, 2, 64), dtype=np.int64)
    for p in [0, 1, 5, 63, 64, 100, -3, -64]:
        want = np.asarray(znx_rotate(p, a))
        have = native.znx_rotate(p, a)
        np.testing.assert_array_equal(have, want)


def test_znx_automorphism_matches_hal():
    from poulpy_tpu.hal.znx import znx_automorphism

    a = RNG.integers(-(2**40), 2**40, size=(2, 64), dtype=np.int64)
    for p in [1, 3, 5, 127, 2 * 64 - 1]:
        want = np.asarray(znx_automorphism(p, a))
        have = native.znx_automorphism(p, a)
        np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("lsh", [0, 3])
def test_vec_znx_normalize_matches_hal(lsh):
    from poulpy_tpu.hal.normalization import vec_znx_normalize

    a = RNG.integers(-(2**50), 2**50, size=(2, 4, 64), dtype=np.int64)
    want = np.asarray(vec_znx_normalize(17, a, lsh))
    have = native.vec_znx_normalize(17, a, lsh)
    np.testing.assert_array_equal(have, want)


def test_negacyclic_conv_matches_bigint():
    n = 32
    a = [int(v) for v in RNG.integers(-(2**30), 2**30, size=n)]
    b = [int(v) for v in RNG.integers(-(2**30), 2**30, size=n)]
    # Python big-int loop (the original oracle)
    out = [0] * n
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] += ai * bj
            else:
                out[k - n] -= ai * bj
    have = native.negacyclic_mul_exact(a, b)
    assert have == out


def test_negacyclic_conv_overflow_guard():
    n = 8
    big = [1 << 62] * n
    with pytest.raises(OverflowError):
        native.negacyclic_mul_exact(big, big)


@pytest.mark.parametrize("n", [64, 256])
def test_ntt_roundtrip_matches_hal(n):
    from poulpy_tpu.hal.module import get_module
    from poulpy_tpu.hal.ntt import _host_tables, ntt_forward, ntt_inverse

    m = get_module(n, 2)
    t = m.tables
    psi_t, psi_inv_t, n_inv = _host_tables(t.basis.primes, n)
    x = np.zeros((3, 2, n), dtype=np.int64)
    for i, p in enumerate(t.basis.primes):
        x[:, i, :] = RNG.integers(0, p, size=(3, n))

    import jax.numpy as jnp

    want_f = np.asarray(ntt_forward(t, jnp.asarray(x)))
    have_f = x.copy()
    for i, p in enumerate(t.basis.primes):
        have_f[:, i, :] = native.ntt_forward(
            psi_t[i], int(p), int(t.basis.qinv_arr[i]), x[:, i, :]
        )
    np.testing.assert_array_equal(have_f, want_f)

    want_b = np.asarray(ntt_inverse(t, jnp.asarray(want_f)))
    have_b = have_f.copy()
    for i, p in enumerate(t.basis.primes):
        have_b[:, i, :] = native.ntt_inverse(
            psi_inv_t[i], int(n_inv[i]), int(p),
            int(t.basis.qinv_arr[i]), have_f[:, i, :],
        )
    np.testing.assert_array_equal(have_b, want_b)
    np.testing.assert_array_equal(have_b, x)
