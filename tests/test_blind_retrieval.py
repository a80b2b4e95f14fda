"""Streaming blind retrieval + cswap butterfly tests (behavioral spec:
poulpy-bin-fhe/src/bdd_arithmetic/blind_retrieval.rs)."""

import numpy as np
import pytest

import jax.numpy as jnp

from poulpy_tpu.binfhe import bdd as bddm
from poulpy_tpu.binfhe.blind_retrieval import (
    GLWEBlindRetriever,
    glwe_blind_retrieval,
    glwe_blind_retrieval_rev,
    glwe_cswap,
)
from poulpy_tpu.core import decryption as dec
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.layouts import GLWEPlaintext
from poulpy_tpu.core.prepared import ggsw_prepare, glwe_secret_prepare
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source

RNG = np.random.default_rng(23)

BASE2K = 17
K_CT = 51
K_SEL = 68
PT_K = 30


@pytest.fixture(scope="module")
def ctx():
    m = get_module(64, 4)
    src = Source(b"\x20" * 32)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, src))
    return m, skp


def _sel_bits(m, skp, value, width, seed=0x30):
    xe, xa = Source(bytes([seed] * 32)), Source(bytes([seed + 1] * 32))
    bits = []
    for i in range(width):
        b = (value >> i) & 1
        pt = jnp.zeros((m.n,), jnp.int64).at[0].set(b)
        g = enc.ggsw_encrypt_sk(
            m, pt, skp, BASE2K, K_SEL, dnum=3, source_xe=xe, source_xa=xa
        )
        bits.append(ggsw_prepare(m, g))
    return bddm.FheUintPrepared(bits=bits, width=width)


def _encrypt_all(m, skp, datas, seed=0x40):
    xe, xa = Source(bytes([seed] * 32)), Source(bytes([seed + 1] * 32))
    cts = []
    for d in datas:
        pt = GLWEPlaintext(
            data=vec_znx.encode_vec_i64(BASE2K, PT_K, 2, jnp.asarray(d)),
            base2k=BASE2K, k=PT_K,
        )
        cts.append(enc.glwe_encrypt_sk(m, pt, skp, BASE2K, K_CT, xe, xa))
    return cts


def _decode(m, skp, ct):
    ptd = dec.glwe_decrypt(m, ct, skp)
    return np.asarray(vec_znx.decode_vec_i64(BASE2K, PT_K, ptd.data))


def test_streaming_retriever_matches_flat_tree(ctx):
    """The carry-save retriever's combine schedule is the same binary tree
    as blind_select's, so outputs are BIT-EXACT equal."""
    m, skp = ctx
    n_in = 16
    datas = [
        RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
        for _ in range(n_in)
    ]
    cts = _encrypt_all(m, skp, datas)
    for idx in [0, 5, 15]:
        sel = _sel_bits(m, skp, idx, 4, seed=0x50 + 2 * idx)
        flat = bddm.blind_select(m, sel, cts)
        ret = GLWEBlindRetriever(n_in)
        stream = ret.retrieve(m, cts, sel)
        assert np.array_equal(np.asarray(flat.data), np.asarray(stream.data))
        got = _decode(m, skp, stream)
        assert np.abs(got - datas[idx]).max() <= 64, idx


def test_streaming_retriever_non_power_of_two(ctx):
    """5 inputs (partial blocks merge in flush) still match blind_select
    bit-exactly and decrypt to the selected element."""
    m, skp = ctx
    datas = [
        RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
        for _ in range(5)
    ]
    cts = _encrypt_all(m, skp, datas, seed=0x60)
    for idx in [2, 4]:
        sel = _sel_bits(m, skp, idx, 3, seed=0x70 + 2 * idx)
        flat = bddm.blind_select(m, sel, cts)
        stream = GLWEBlindRetriever(5).retrieve(m, cts, sel)
        assert np.array_equal(np.asarray(flat.data), np.asarray(stream.data))
        got = _decode(m, skp, stream)
        assert np.abs(got - datas[idx]).max() <= 64, idx


def test_streaming_retriever_incremental_and_offset(ctx):
    """add()-one-at-a-time keeps only O(log n) live slots; the offset
    parameter selects a sub-field of the index bits (ref add :79)."""
    m, skp = ctx
    datas = [
        RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
        for _ in range(4)
    ]
    cts = _encrypt_all(m, skp, datas, seed=0x80)
    # selector encrypts 0b1101; offset=2 -> retrieval index = 0b11 = 3
    sel = _sel_bits(m, skp, 0b1101, 4, seed=0x90)
    ret = GLWEBlindRetriever(4)
    for ct in cts:
        ret.add(m, ct, sel, offset=2)
        assert sum(s[1] for s in ret._slots) <= 2  # O(log n) live state
    out = ret.flush(m, sel, offset=2)
    got = _decode(m, skp, out)
    assert np.abs(got - datas[3]).max() <= 64

    # capacity guard (ref: "Accumulating limit of {} reached")
    ret2 = GLWEBlindRetriever(2)
    ret2.add(m, cts[0], sel)
    ret2.add(m, cts[1], sel)
    with pytest.raises(ValueError, match="limit"):
        ret2.add(m, cts[2], sel)
    with pytest.raises(ValueError):
        GLWEBlindRetriever(4).flush(m, sel)


def test_cswap(ctx):
    """Cswap: identity under bit=0, exchange under bit=1
    (bdd_arithmetic/eval.rs:417)."""
    m, skp = ctx
    da = RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
    db = RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
    ca, cb = _encrypt_all(m, skp, [da, db], seed=0xA0)
    for bit, (wa, wb) in [(0, (da, db)), (1, (db, da))]:
        sel = _sel_bits(m, skp, bit, 1, seed=0xB0 + bit)
        oa, ob = glwe_cswap(m, ca, cb, sel.bits[0])
        assert np.abs(_decode(m, skp, oa) - wa).max() <= 32
        assert np.abs(_decode(m, skp, ob) - wb).max() <= 32


def test_butterfly_retrieval_and_rev(ctx):
    """glwe_blind_retrieval: res[0] == cts[(idx >> rsh) % 2^mask]; the _rev
    network restores the original order (packed-word usage: each GLWE packs
    a full polynomial of word coefficients)."""
    m, skp = ctx
    n_in = 8
    datas = [
        RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
        for _ in range(n_in)
    ]
    cts = _encrypt_all(m, skp, datas, seed=0xC0)

    for idx in [0, 3, 6]:
        sel = _sel_bits(m, skp, idx, 3, seed=0xD0 + 2 * idx)
        res = glwe_blind_retrieval(m, cts, sel)
        got = _decode(m, skp, res[0])
        assert np.abs(got - datas[idx]).max() <= 64, idx
        # undo: every position decrypts back to its original element
        back = glwe_blind_retrieval_rev(m, res, sel)
        for j in range(n_in):
            gj = _decode(m, skp, back[j])
            assert np.abs(gj - datas[j]).max() <= 128, (idx, j)

    # sub-field selection: selector 0b110, rsh=1, mask=2 -> index 3
    sel = _sel_bits(m, skp, 0b110, 3, seed=0xE8)
    res = glwe_blind_retrieval(m, cts[:4], sel, bit_rsh=1, bit_mask=2)
    got = _decode(m, skp, res[0])
    assert np.abs(got - datas[3]).max() <= 64


def test_blind_selection_sparse_map(ctx):
    """Map-keyed oblivious selection (blind_selection.rs:13-120): selects
    a[idx] from a dict; absent indices act as encryptions of zero; sub-
    field selection honors bit_rsh/bit_mask."""
    from poulpy_tpu.binfhe.blind_retrieval import glwe_blind_selection

    m, skp = ctx
    datas = {i: RNG.integers(-(2**12), 2**12, size=m.n, dtype=np.int64)
             for i in [0, 2, 3, 5]}      # sparse: 1, 4, 6, 7 missing
    cts_list = _encrypt_all(m, skp, list(datas.values()), seed=0xF0)
    cts = dict(zip(datas.keys(), cts_list))

    for idx in [0, 3, 5]:
        sel = _sel_bits(m, skp, idx, 3, seed=0x10 + 2 * idx)
        out = glwe_blind_selection(m, cts, sel, bit_mask=3)
        got = _decode(m, skp, out)
        assert np.abs(got - datas[idx]).max() <= 64, idx

    # absent index decrypts to ~zero
    sel = _sel_bits(m, skp, 4, 3, seed=0x1c)
    out = glwe_blind_selection(m, cts, sel, bit_mask=3)
    assert np.abs(_decode(m, skp, out)).max() <= 64

    # sub-field: selector 0b101, rsh=1 mask=2 -> index 2
    sel = _sel_bits(m, skp, 0b101, 3, seed=0x1e)
    out = glwe_blind_selection(m, cts, sel, bit_rsh=1, bit_mask=2)
    assert np.abs(_decode(m, skp, out) - datas[2]).max() <= 64
