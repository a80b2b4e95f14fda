"""Compressed ciphertext layer (poulpy-core/src/layouts/compressed/).

Every sk-encrypted object can store only its body column plus the 32-byte
seed of the mask stream; `*_decompress` regenerates the mask columns from
the seed (glwe.rs:20, gglwe.rs:22, ggsw.rs:21).  Halves-to-(rank+1)ths key
material size for transport/storage.
"""

from __future__ import annotations

import jax.numpy as jnp

from poulpy_tpu.core.encryption import NoiseInfos, encrypt_sk_internal
from poulpy_tpu.core.layouts import GLWECiphertext, glwe_size
from poulpy_tpu.core.prepared import GLWESecretPrepared
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.source import Source
from poulpy_tpu.utils import struct


def _static(**kw):
    return struct.field(pytree_node=False, **kw)


@struct.dataclass
class GLWECompressed:
    """Body column + mask seed (layouts/compressed/glwe.rs:20)."""

    body: jnp.ndarray  # [..., size, N]
    seed: bytes = _static()
    base2k: int = _static()
    k: int = _static()
    rank: int = _static(default=1)


def glwe_encrypt_sk_compressed(
    module: Module,
    pt,
    sk: GLWESecretPrepared,
    base2k: int,
    k: int,
    source_xe: Source,
    source_xa: Source,
    batch_shape: tuple = (),
    **kw,
) -> GLWECompressed:
    """Draw a fresh mask seed from source_xa (Source.branch, the reference's
    compressed-encryption pattern), encrypt, keep only the body."""
    seed, child = source_xa.branch()
    noise = NoiseInfos(k=k, **{k_: v for k_, v in kw.items() if k_ in ("sigma", "bound")})
    size = glwe_size(base2k, k)
    data = encrypt_sk_internal(
        module, base2k, size,
        None if pt is None else pt.data, 0, sk, noise,
        source_xe, child, batch_shape,
    )
    return GLWECompressed(
        body=data[..., 0, :, :], seed=seed, base2k=base2k, k=k, rank=sk.rank
    )


def glwe_decompress(module: Module, ct: GLWECompressed) -> GLWECiphertext:
    """Regenerate the mask columns from the seed (GLWEDecompress)."""
    source = Source(ct.seed)
    size = ct.body.shape[-2]
    n = module.n
    batch = ct.body.shape[:-2]
    mask = jnp.asarray(
        source.uniform_digits(ct.base2k, batch + (ct.rank, size, n))
    )
    data = jnp.concatenate([ct.body[..., None, :, :], mask], axis=-3)
    return GLWECiphertext(data=data, base2k=ct.base2k, k=ct.k)


@struct.dataclass
class GGLWECompressed:
    """Gadget-GLWE bodies + one mask seed per row/col
    (layouts/compressed/gglwe.rs:22)."""

    body: jnp.ndarray   # [dnum, rank_in, size, N]
    seed: bytes = _static()
    base2k: int = _static()
    k: int = _static()
    rank_out: int = _static(default=1)
    dsize: int = _static(default=1)


def gglwe_encrypt_sk_compressed(
    module: Module, pt, sk: GLWESecretPrepared, base2k: int, k: int,
    dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1, **kw,
) -> GGLWECompressed:
    """Compressed GGLWE: encrypt normally with a branched mask stream, store
    only the body column + seed (compressed/gglwe.rs)."""
    from poulpy_tpu.core.encryption import gglwe_encrypt_sk

    seed, child = source_xa.branch()
    ct = gglwe_encrypt_sk(
        module, pt, sk, base2k, k, dnum, source_xe, child, dsize=dsize, **kw
    )
    return GGLWECompressed(
        body=ct.data[..., 0, :, :], seed=seed, base2k=base2k, k=k,
        rank_out=sk.rank, dsize=dsize,
    )


@struct.dataclass
class LWECompressed:
    """LWE body limbs + mask seed (layouts/compressed/lwe.rs).

    Valid because uniform_digits samples are already in balanced-digit
    normal form, so the stored mask columns equal the raw stream."""

    body: jnp.ndarray   # [..., size, 1]
    seed: bytes = _static()
    base2k: int = _static()
    k: int = _static()
    n_lwe: int = _static(default=0)


def lwe_encrypt_sk_compressed(
    module_unused, pt, sk_lwe, base2k: int, k: int,
    source_xe: Source, source_xa: Source, **kw,
) -> LWECompressed:
    from poulpy_tpu.core.encryption import lwe_encrypt_sk

    seed, child = source_xa.branch()
    ct = lwe_encrypt_sk(None, pt, sk_lwe, base2k, k, source_xe, child, **kw)
    return LWECompressed(
        body=ct.data[..., :, 0:1], seed=seed, base2k=base2k, k=k,
        n_lwe=int(sk_lwe.shape[-1]),
    )


def lwe_decompress(ct: LWECompressed):
    from poulpy_tpu.core.layouts import LWECiphertext

    source = Source(ct.seed)
    size = ct.body.shape[-2]
    batch = ct.body.shape[:-2]
    a = jnp.asarray(source.uniform_digits(ct.base2k, batch + (size, ct.n_lwe)))
    data = jnp.concatenate([ct.body, a], axis=-1)
    return LWECiphertext(data=data, base2k=ct.base2k, k=ct.k)


def glwe_switching_key_encrypt_sk_compressed(
    module: Module, sk_in, sk_out: GLWESecretPrepared, base2k: int, k: int,
    dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1, **kw,
) -> GGLWECompressed:
    """Seeded switching key (compressed/glwe_switching_key.rs) — the GGLWE
    compression applied to the switching-key plaintext columns."""
    return gglwe_encrypt_sk_compressed(
        module, sk_in.data, sk_out, base2k, k, dnum,
        source_xe, source_xa, dsize=dsize, **kw,
    )


def glwe_automorphism_key_encrypt_sk_compressed(
    module: Module, p: int, sk, base2k: int, k: int, dnum: int,
    source_xe: Source, source_xa: Source, dsize: int = 1, **kw,
):
    """Seeded automorphism key (compressed/glwe_automorphism_key.rs):
    same permuted-secret construction as the direct keygen
    (encryption/glwe_automorphism_key.rs:88-107), bodies + seed only."""
    from poulpy_tpu.core.layouts import GLWESecret
    from poulpy_tpu.core.prepared import glwe_secret_prepare
    from poulpy_tpu.hal.vec_znx import vec_znx_automorphism

    p_inv = pow(int(p) % (2 * module.n), -1, 2 * module.n)
    sk_out = GLWESecret(
        data=vec_znx_automorphism(p_inv, sk.data), dist=sk.dist
    )
    key = gglwe_encrypt_sk_compressed(
        module, sk.data, glwe_secret_prepare(module, sk_out), base2k, k,
        dnum, source_xe, source_xa, dsize=dsize, **kw,
    )
    return key, p


def glwe_to_lwe_key_encrypt_sk_compressed(
    module: Module, sk_lwe, sk_glwe, base2k: int, k: int, dnum: int,
    source_xe: Source, source_xa: Source, **kw,
) -> GGLWECompressed:
    """Seeded GLWEToLWEKey (compressed/glwe_to_lwe_key.rs): the switching
    key sk_glwe → embedded sk_lwe, bodies + seed."""
    from poulpy_tpu.core.conversion import lwe_secret_as_glwe
    from poulpy_tpu.core.prepared import glwe_secret_prepare

    sk_emb_prep = glwe_secret_prepare(
        module, lwe_secret_as_glwe(module, sk_lwe)
    )
    return glwe_switching_key_encrypt_sk_compressed(
        module, sk_glwe, sk_emb_prep, base2k, k, dnum,
        source_xe, source_xa, **kw,
    )


def lwe_to_glwe_key_encrypt_sk_compressed(
    module: Module, sk_lwe, sk_glwe_prepared, base2k: int, k: int, dnum: int,
    source_xe: Source, source_xa: Source, **kw,
) -> GGLWECompressed:
    """Seeded LWEToGLWEKey (compressed/lwe_to_glwe_key.rs)."""
    from poulpy_tpu.core.conversion import lwe_secret_as_glwe

    sk_emb = lwe_secret_as_glwe(module, sk_lwe)
    return glwe_switching_key_encrypt_sk_compressed(
        module, sk_emb, sk_glwe_prepared, base2k, k, dnum,
        source_xe, source_xa, **kw,
    )


def glwe_tensor_key_encrypt_sk_compressed(
    module: Module, sk, sk_prepared: GLWESecretPrepared, base2k: int, k: int,
    dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1, **kw,
) -> dict:
    """Seeded tensor/relinearization key (compressed/glwe_tensor_key.rs):
    one seeded GGLWE per (i ≤ j) secret pair, each on its own branch of
    the mask stream."""
    from poulpy_tpu.hal import dft

    rank = sk.rank
    keys = {}
    for i in range(rank):
        for j in range(i, rank):
            si_dft = dft.dft_apply(module, sk.data[i][None, :])
            sj_p = dft.svp_prepare(module, sk.data[j])
            sisj = dft.idft_apply(module, dft.svp_apply(module, si_dft, sj_p))[0]
            keys[(i, j)] = gglwe_encrypt_sk_compressed(
                module, sisj[None, :], sk_prepared, base2k, k, dnum,
                source_xe, source_xa, dsize=dsize, **kw,
            )
    return keys


def glwe_tensor_key_decompress(module: Module, keys: dict) -> dict:
    return {ij: gglwe_decompress(module, c) for ij, c in keys.items()}


def gglwe_to_ggsw_key_encrypt_sk_compressed(
    module: Module, sk, sk_prepared: GLWESecretPrepared, base2k: int, k: int,
    dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1, **kw,
) -> list[GGLWECompressed]:
    """Seeded GGLWEToGGSWKey (compressed/gglwe_to_ggsw_key.rs:20-113): one
    seeded GGLWE per rank element j, each encrypting (s_j·s_0, …,
    s_j·s_{rank-1}) on its own branch of the mask stream — the same
    plaintext construction as conversion.gglwe_to_ggsw_key_encrypt_sk."""
    from poulpy_tpu.hal import dft

    rank = sk.rank
    keys = []
    for j in range(rank):
        sj_p = dft.svp_prepare(module, sk.data[j])
        pts = []
        for i in range(rank):
            si_dft = dft.dft_apply(module, sk.data[i][None, :])
            pts.append(
                dft.idft_apply(module, dft.svp_apply(module, si_dft, sj_p))[0]
            )
        pt = jnp.stack(pts, axis=0)
        keys.append(gglwe_encrypt_sk_compressed(
            module, pt, sk_prepared, base2k, k, dnum,
            source_xe, source_xa, dsize=dsize, **kw,
        ))
    return keys


def gglwe_to_ggsw_key_decompress(module: Module, keys: list[GGLWECompressed]):
    """Regenerate the full prepared key list — the decompressed form feeds
    conversion.ggsw_from_gglwe directly (matching the non-compressed
    keygen's list[GGLWEPrepared] return)."""
    from poulpy_tpu.core.prepared import gglwe_prepare

    return [gglwe_prepare(module, gglwe_decompress(module, c)) for c in keys]


def lwe_switching_key_encrypt_sk_compressed(
    module: Module, sk_lwe_in, sk_lwe_out, base2k: int, k: int, dnum: int,
    source_xe: Source, source_xa: Source, **kw,
) -> GGLWECompressed:
    """Seeded LWESwitchingKey (compressed/lwe_switching_key.rs:18-115): the
    seeded rank-1 GLWE switching key between the φ_{-1}-embedded images of
    the two LWE secrets (newtype in the reference)."""
    from poulpy_tpu.core.conversion import lwe_secret_as_glwe
    from poulpy_tpu.core.prepared import glwe_secret_prepare

    sk_in = lwe_secret_as_glwe(module, sk_lwe_in)
    sk_out_prep = glwe_secret_prepare(
        module, lwe_secret_as_glwe(module, sk_lwe_out)
    )
    return glwe_switching_key_encrypt_sk_compressed(
        module, sk_in, sk_out_prep, base2k, k, dnum,
        source_xe, source_xa, **kw,
    )


def lwe_switching_key_decompress(module: Module, c: GGLWECompressed):
    """Prepared form, ready for keyswitching.lwe_keyswitch."""
    from poulpy_tpu.core.prepared import gglwe_prepare

    return gglwe_prepare(module, gglwe_decompress(module, c))


@struct.dataclass
class GGSWCompressed:
    """GGSW bodies + one mask seed (layouts/compressed/ggsw.rs:21).

    A plaintext in ciphertext column j > 0 is realized against the *raw*
    uniform column (encrypt_sk_internal computes the body with
    norm(mask_j − pt) but stores mask_j itself), so body + seed losslessly
    reconstructs every column."""

    body: jnp.ndarray   # [..., dnum, rank+1 (pt cols), size, N]
    seed: bytes = _static()
    base2k: int = _static()
    k: int = _static()
    dsize: int = _static(default=1)


def ggsw_encrypt_sk_compressed(
    module: Module, pt, sk: GLWESecretPrepared, base2k: int, k: int,
    dnum: int, source_xe: Source, source_xa: Source, dsize: int = 1, **kw,
) -> GGSWCompressed:
    """Compressed GGSW: branched mask stream, body column only."""
    from poulpy_tpu.core.encryption import ggsw_encrypt_sk

    seed, child = source_xa.branch()
    ct = ggsw_encrypt_sk(
        module, pt, sk, base2k, k, dnum, source_xe, child, dsize=dsize, **kw
    )
    return GGSWCompressed(
        body=ct.data[..., 0, :, :], seed=seed, base2k=base2k, k=k, dsize=dsize
    )


def ggsw_decompress(module: Module, ct: GGSWCompressed):
    """Replay ggsw_encrypt_sk's sampling order: one uniform mask block of
    shape batch+(dnum, rank, size, N) per plaintext column j."""
    from poulpy_tpu.core.layouts import GGSWCiphertext

    source = Source(ct.seed)
    *batch, dnum, cols, size, n = ct.body.shape
    rank = cols - 1
    parts = []
    for j in range(cols):
        mask = jnp.asarray(
            source.uniform_digits(
                ct.base2k, tuple(batch) + (dnum, rank, size, n)
            )
        )
        parts.append(
            jnp.concatenate(
                [ct.body[..., j, None, :, :], mask], axis=-3
            )
        )
    data = jnp.stack(parts, axis=-4)  # [..., dnum, rank+1, rank+1, size, N]
    return GGSWCiphertext(data=data, base2k=ct.base2k, k=ct.k, dsize=ct.dsize)


def gglwe_decompress(module: Module, ct: GGLWECompressed):
    """Regenerate every mask column from the seed, replaying the keygen's
    sampling order (gglwe_encrypt_sk batches rows per input column)."""
    from poulpy_tpu.core.layouts import GGLWECiphertext

    source = Source(ct.seed)
    dnum, rank_in, size, n = ct.body.shape
    cols = []
    for i in range(rank_in):
        mask = jnp.asarray(
            source.uniform_digits(ct.base2k, (dnum, ct.rank_out, size, n))
        )
        cols.append(mask)
    mask = jnp.stack(cols, axis=1)  # [dnum, rank_in, rank_out, size, N]
    data = jnp.concatenate([ct.body[..., None, :, :], mask], axis=-3)
    return GGLWECiphertext(data=data, base2k=ct.base2k, k=ct.k, dsize=ct.dsize)
