"""Layout (de)serialization round trips (poulpy-hal WriterTo/ReaderFrom +
the generic_serialization test pattern, poulpy-bin-fhe blind_rotation
tests/test_suite/generic_serialization.rs)."""

import numpy as np
import jax.numpy as jnp
import pytest

from poulpy_tpu.core import compressed as comp
from poulpy_tpu.core import encryption as enc
from poulpy_tpu.core.layouts import GLWECiphertext, GLWEPlaintext
from poulpy_tpu.core.prepared import glwe_secret_prepare
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import get_module
from poulpy_tpu.hal.source import Source
from poulpy_tpu.utils.serialization import (
    deserialize_layout,
    digest_u64,
    serialize_layout,
)

N = 64
BASE2K = 17
RNG = np.random.default_rng(13)


def _ct():
    m = get_module(N, 2)
    sk = enc.secret_new(m, 1, Source(bytes(32)))
    skp = glwe_secret_prepare(m, sk)
    data = RNG.integers(-(2**15), 2**15, size=N, dtype=np.int64)
    pt = GLWEPlaintext(
        data=vec_znx.encode_vec_i64(BASE2K, 34, 3, jnp.asarray(data)),
        base2k=BASE2K, k=34,
    )
    return m, skp, pt, enc.glwe_encrypt_sk(
        m, pt, skp, BASE2K, 51, Source(b"\x01" * 32), Source(b"\x02" * 32)
    )


def test_glwe_roundtrip():
    _, _, _, ct = _ct()
    blob = serialize_layout(ct)
    back = deserialize_layout(blob, GLWECiphertext)
    assert back.base2k == ct.base2k and back.k == ct.k
    assert jnp.array_equal(back.data, ct.data)


def test_compressed_roundtrip_with_seed():
    m, skp, pt, _ = _ct()
    ct_c = comp.glwe_encrypt_sk_compressed(
        m, pt, skp, BASE2K, 51, Source(b"\x01" * 32), Source(b"\x02" * 32)
    )
    blob = serialize_layout(ct_c)
    back = deserialize_layout(blob, comp.GLWECompressed)
    assert back.seed == ct_c.seed and isinstance(back.seed, bytes)
    assert jnp.array_equal(back.body, ct_c.body)
    # the wire form is usable: decompress both and compare
    assert jnp.array_equal(
        comp.glwe_decompress(m, back).data,
        comp.glwe_decompress(m, ct_c).data,
    )


def test_type_mismatch_rejected():
    _, _, _, ct = _ct()
    blob = serialize_layout(ct)
    with pytest.raises(ValueError, match="type mismatch"):
        deserialize_layout(blob, comp.GLWECompressed)


def test_digest_stable():
    _, _, _, ct = _ct()
    d1 = digest_u64(ct.data)
    d2 = digest_u64(np.asarray(ct.data).copy())
    assert d1 == d2
    assert d1 != digest_u64(np.asarray(ct.data) + 1)


def test_ggsw_and_key_roundtrips():
    """GGSW ct, GGLWE switching key, prepared GGSW, and the compressed
    blind-rotation key all survive the wire."""
    from poulpy_tpu.binfhe.blind_rotation import (
        BlindRotationKeyCompressed,
        blind_rotation_key_decompress,
        blind_rotation_key_encrypt_sk_compressed,
    )
    from poulpy_tpu.core.layouts import GGLWECiphertext, GGSWCiphertext
    from poulpy_tpu.core.prepared import GGSWPrepared, ggsw_prepare

    m, skp, pt, _ = _ct()
    xe, xa = Source(b"\x03" * 32), Source(b"\x04" * 32)
    sk = enc.secret_new(m, 1, Source(bytes(32)))

    ptg = np.zeros(N, dtype=np.int64)
    ptg[2] = 1
    ggsw = enc.ggsw_encrypt_sk(
        m, jnp.asarray(ptg), skp, BASE2K, 68, dnum=3,
        source_xe=xe, source_xa=xa,
    )
    back = deserialize_layout(serialize_layout(ggsw), GGSWCiphertext)
    assert back.dsize == ggsw.dsize and back.k == ggsw.k
    assert jnp.array_equal(back.data, ggsw.data)

    ksk = enc.glwe_switching_key_encrypt_sk(
        m, sk, skp, BASE2K, 68, dnum=3, source_xe=xe, source_xa=xa
    )
    back = deserialize_layout(serialize_layout(ksk), GGLWECiphertext)
    assert jnp.array_equal(back.data, ksk.data)

    prep = ggsw_prepare(m, ggsw)
    back = deserialize_layout(serialize_layout(prep), GGSWPrepared)
    assert jnp.array_equal(back.pmat, prep.pmat)

    brk_c = blind_rotation_key_encrypt_sk_compressed(
        m, jnp.asarray(Source(b"\x09" * 32).binary_prob((8,))), skp,
        BASE2K, 68, 3, xe, xa,
    )
    blob = serialize_layout(brk_c.ggsw)
    back_ggsw = deserialize_layout(blob, type(brk_c.ggsw))
    back_brk = BlindRotationKeyCompressed(ggsw=back_ggsw, dist=brk_c.dist)
    want = blind_rotation_key_decompress(m, brk_c)
    have = blind_rotation_key_decompress(m, back_brk)
    assert jnp.array_equal(have.pmats, want.pmats)


def test_nested_layout_roundtrip():
    """Nested layout dataclasses (CKKS ciphertext = GLWE + meta) survive
    the wire — the reference's WriterTo covers scheme-level objects too
    (poulpy-ckks ciphertext serialization)."""
    from poulpy_tpu.ckks.layouts import CKKSCiphertext, CKKSMeta
    from poulpy_tpu.ckks.plaintext import CKKSPlaintextCstZnx
    from poulpy_tpu.core.layouts import GLWECiphertext

    g = GLWECiphertext(
        data=jnp.arange(48, dtype=jnp.int64).reshape(2, 3, 8),
        base2k=17, k=51,
    )
    c = CKKSCiphertext(glwe=g, meta=CKKSMeta(log_delta=22, log_budget=30))
    back = deserialize_layout(serialize_layout(c), CKKSCiphertext)
    assert back.meta == c.meta
    assert back.glwe.base2k == 17 and back.glwe.k == 51
    assert jnp.array_equal(back.glwe.data, g.data)

    # None-able + int statics (quantized constant plaintext)
    z = CKKSPlaintextCstZnx(
        re=314159, im=None, meta=CKKSMeta(log_delta=20, log_budget=0)
    )
    b2 = deserialize_layout(serialize_layout(z), CKKSPlaintextCstZnx)
    assert b2.re == 314159 and b2.im is None and b2.meta == z.meta
