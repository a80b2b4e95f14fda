"""The product pipelines of the core API against exact big-int oracles.

External product, keyswitch (with its body add) and rank-1 tensor product +
relinearization run through their public entry points on random limb
digits and random gadget matrices; the expected limbs come from
tests/oracle.py: exact negacyclic products, exact sums, and the floor-
per-limb normalization model.  Nothing on the NTT/Montgomery/Garner side is
shared with the oracle, so a wrong twiddle, reduction or lift shows up as a
wrong digit.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import oracle
from poulpy_tpu.core.external_product import glwe_external_product
from poulpy_tpu.core.keyswitching import glwe_keyswitch
from poulpy_tpu.core.layouts import GLWECiphertext
from poulpy_tpu.core.operations import glwe_tensor_relinearize
from poulpy_tpu.core.prepared import (
    GGLWEPrepared,
    GGSWPrepared,
    GLWETensorKeyPrepared,
)
from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import get_module

N = 64
B = 17               # base2k of inputs, keys and outputs
RES_SIZE = 3
PRIMES = [(2, 30), (4, 30), (2, 28)]
RNG = np.random.default_rng(11)


def digits(shape):
    """Normalized base-2^B limb digits."""
    return RNG.integers(-(2 ** (B - 1)), 2 ** (B - 1), size=shape,
                        dtype=np.int64)


def glwe(a):
    return GLWECiphertext(data=jnp.asarray(a), base2k=B, k=a.shape[-2] * B)


@pytest.mark.parametrize("nprimes,prime_bits", PRIMES)
@pytest.mark.parametrize(
    "cols,rows,size_a,psize,batch",
    [
        (2, 3, 3, 4, 4),     # rank 1, the bench configuration's shape
        (3, 2, 3, 3, 1),     # rank 2
        (2, 4, 3, 4, 5),     # more gadget rows than input limbs
    ],
)
def test_external_product_matches_oracle(nprimes, prime_bits, cols, rows,
                                         size_a, psize, batch):
    m = get_module(N, nprimes, prime_bits)
    a = digits((batch, cols, size_a, N))
    mat = digits((rows, cols, cols, psize, N))
    ggsw = GGSWPrepared(pmat=dft.vmp_prepare(m, jnp.asarray(mat)), base2k=B,
                        k=psize * B)
    have = np.asarray(
        glwe_external_product(m, glwe(a), ggsw, B, RES_SIZE * B).data
    )
    assert have.shape == (batch, cols, RES_SIZE, N)
    for b in range(batch):
        big = oracle.vmp(a[b], mat)
        for co in range(cols):
            want = oracle.normalize(big[co], B, RES_SIZE, B)
            assert np.array_equal(have[b, co], want), (b, co)


@pytest.mark.parametrize("nprimes,prime_bits", PRIMES)
@pytest.mark.parametrize(
    "rows,size_a,psize,batch",
    [
        (4, 4, 4, 3),        # rows = limbs
        (3, 3, 4, 3),        # body shorter than the key: zero-padded
        (3, 5, 4, 2),        # body longer than the key: truncated
    ],
)
def test_keyswitch_matches_oracle(nprimes, prime_bits, rows, size_a, psize,
                                  batch):
    """Mask through the switching key, body added to column 0 before the
    normalization (the keyswitch `small` add)."""
    m = get_module(N, nprimes, prime_bits)
    a = digits((batch, 2, size_a, N))
    mat = digits((rows, 1, 2, psize, N))
    key = GGLWEPrepared(pmat=dft.vmp_prepare(m, jnp.asarray(mat)), base2k=B,
                        k=psize * B)
    have = np.asarray(glwe_keyswitch(m, glwe(a), key, B, RES_SIZE * B).data)
    for b in range(batch):
        big = oracle.vmp(a[b, 1:], mat)
        body = oracle.align(a[b, 0], psize, N)
        big[0] = [oracle.poly_add(x, y) for x, y in zip(big[0], body)]
        for co in range(2):
            want = oracle.normalize(big[co], B, RES_SIZE, B)
            assert np.array_equal(have[b, co], want), (b, co)


@pytest.mark.parametrize("prime_bits", [30, 28])
@pytest.mark.parametrize(
    "dsize,rows,size_a",
    [(2, 3, 6), (2, 3, 5), (3, 2, 6), (2, 4, 3)],
)
def test_external_product_dsize_matches_oracle(prime_bits, dsize, rows,
                                               size_a):
    """dsize > 1: input limbs grouped by digit residue, each group through
    the gadget with its own output limb offset, summed."""
    m = get_module(N, 2, prime_bits)
    cols, psize, batch = 2, 4, 3
    a = digits((batch, cols, size_a, N))
    mat = digits((rows, cols, cols, psize, N))
    ggsw = GGSWPrepared(pmat=dft.vmp_prepare(m, jnp.asarray(mat)), base2k=B,
                        k=psize * B, dsize=dsize)
    have = np.asarray(
        glwe_external_product(m, glwe(a), ggsw, B, RES_SIZE * B).data
    )
    for b in range(batch):
        big = [[[0] * N for _ in range(psize)] for _ in range(cols)]
        for di in range(dsize):
            ai_size = min((size_a + di) // dsize, rows)
            if ai_size == 0:
                continue
            limbs = [dsize - 1 - di + r * dsize for r in range(ai_size)]
            ai = np.zeros((cols, ai_size, N), dtype=np.int64)
            for r, limb in enumerate(limbs):
                if limb < size_a:
                    ai[:, r] = a[b, :, limb]
            part = oracle.vmp(ai, mat, limb_offset=di)
            big = [[oracle.poly_add(x, y) for x, y in zip(bc, pc)]
                   for bc, pc in zip(big, part)]
        for co in range(cols):
            want = oracle.normalize(big[co], B, RES_SIZE, B)
            assert np.array_equal(have[b, co], want), (b, co)


@pytest.mark.parametrize("prime_bits", [30, 28])
@pytest.mark.parametrize("size_a,size_b", [(2, 3), (4, 4)])
def test_tensor_relinearize_matches_oracle(prime_bits, size_a, size_b):
    """Rank-1 ct × ct: limb convolution of the columns, the quadratic term
    normalized into gadget digits and switched through the tensor key, the
    64-bit linear terms added per column (longer or shorter than the key's
    output), then normalized."""
    m = get_module(N, 2, prime_bits)
    rows, psize, batch = 4, 4, 2
    a = digits((batch, 2, size_a, N))
    b_ = digits((batch, 2, size_b, N))
    mat = digits((rows, 1, 2, psize, N))
    key = GGLWEPrepared(pmat=dft.vmp_prepare(m, jnp.asarray(mat)), base2k=B,
                        k=psize * B)
    tk = GLWETensorKeyPrepared(keys={(0, 0): key})
    have = np.asarray(glwe_tensor_relinearize(
        m, glwe(a), glwe(b_), tk, B, RES_SIZE * B
    ).data)
    conv_size = size_a + size_b - 1
    mx = max(psize, conv_size)
    for b in range(batch):
        def conv(i, j):
            return oracle.limb_conv(a[b, i], b_[b, j], conv_size)

        lin = [conv(0, 0), [oracle.poly_add(x, y)
                            for x, y in zip(conv(0, 1), conv(1, 0))]]
        d = oracle.normalize(conv(1, 1), B, rows, B)       # gadget digits
        ks = oracle.vmp(d[None], mat)
        for c in range(2):
            big = [oracle.poly_add(x, y) for x, y in zip(
                oracle.align(ks[c], mx, N), oracle.align(lin[c], mx, N))]
            want = oracle.normalize(big, B, RES_SIZE, B)
            assert np.array_equal(have[b, c], want), (b, c)
