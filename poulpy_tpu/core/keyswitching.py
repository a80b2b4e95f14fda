"""GLWE key switching (poulpy-core/src/keyswitching/glwe.rs).

The hot primitive: DFT the mask limbs, gadget-contract against the prepared
key matrix (VMP), inverse-DFT into the big accumulator, add the body, and
carry-normalize — one linear pass in the number of limbs (stack §3.2 of
SURVEY.md).
"""

from __future__ import annotations

import functools

import jax

from poulpy_tpu.core.layouts import GLWECiphertext, glwe_size
from poulpy_tpu.core.prepared import GGLWEPrepared
from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.normalization import vec_znx_normalize_full


def gglwe_product_dft(
    module: Module,
    a_dft,                      # [..., cols_in, size_a, P, N]
    key: GGLWEPrepared,
):
    """gglwe_product_dft (keyswitching/glwe.rs:253-378).

    dsize == 1: a single VMP.  dsize > 1: bivariate convolution in
    (X, Y=2^{-base2k·dsize}) by grouping limbs of a by digit residue:
    res = Σ_di vmp(a[di::dsize-grouped], pmat, limb_offset=di), with the
    reference's error-limb truncation optimization applied implicitly by
    limiting output size.
    """
    dsize = key.dsize
    pmat = key.pmat
    if dsize == 1:
        return dft.vmp_apply(module, a_dft, pmat)

    dnum = key.dnum
    a_size = a_dft.shape[-3]
    res = None
    for di in range(dsize):
        ai_size = min((a_size + di) // dsize, dnum)
        if ai_size == 0:
            continue
        ai = dft.dft_copy(a_dft, step=dsize, offset=dsize - di - 1, res_size=ai_size)
        part = dft.vmp_apply(module, ai, pmat, limb_offset=di)
        res = part if res is None else dft.dft_add(module, res, part)
    return res


@functools.partial(
    jax.jit, static_argnames=("module", "res_base2k", "res_k")
)
def glwe_keyswitch(
    module: Module,
    a: GLWECiphertext,
    key: GGLWEPrepared,
    res_base2k: int | None = None,
    res_k: int | None = None,
) -> GLWECiphertext:
    """glwe_keyswitch (keyswitching/glwe.rs:53-109 → internal :207-240):

      a_dft[i] = DFT(a[i+1]);  res_dft = gglwe_product(a_dft, key);
      res_big = iDFT(res_dft);  res_big[0] += a[0];  res = big_normalize.
    """
    if module.mesh is not None:
        from poulpy_tpu.parallel.auto import dp_shard

        return dp_shard(
            module,
            lambda a_: glwe_keyswitch(
                module.local, a_, key, res_base2k, res_k
            ),
            a,
        )
    res_base2k = a.base2k if res_base2k is None else res_base2k
    res_k = a.k if res_k is None else res_k
    res_size = glwe_size(res_base2k, res_k)

    if a.base2k != key.base2k:
        a = glwe_normalize(module, a, key.base2k, a.k)

    bits = dft.product_bits(
        key.base2k, key.base2k, module.log_n, key.dnum * max(1, a.rank)
    )
    wide = dft.needs_wide(bits)
    a_dft = dft.dft_apply(module, a.data[..., 1:, :, :])
    res_dft = gglwe_product_dft(module, a_dft, key)
    if wide:
        # i128-twin exit (NTT120 ScalarBig path) for base2k ≳ 26 configs
        from poulpy_tpu.hal.wide import wadd, wfrom_i64

        assert bits + 1 < module.basis.modulus.bit_length()
        hi, lo = dft.idft_apply_wide(module, res_dft)
        upto = min(a.data.shape[-2], hi.shape[-2])
        sh, sl = wfrom_i64(a.data[..., 0, :upto, :])
        nh, nl = wadd(hi[..., 0, :upto, :], lo[..., 0, :upto, :], sh, sl)
        hi = hi.at[..., 0, :upto, :].set(nh)
        lo = lo.at[..., 0, :upto, :].set(nl)
        res = dft.big_normalize_wide(
            module, res_size, res_base2k, (hi, lo), key.base2k
        )
        return GLWECiphertext(data=res, base2k=res_base2k, k=res_k)
    res_big = dft.idft_apply(module, res_dft)
    res_big = res_big.at[..., 0, :, :].add(
        dft._align_limbs(a.data[..., 0, :, :], res_big[..., 0, :, :],
                         res_big.shape[-2], limb_axis=-2)[0]
    )
    res = dft.big_normalize(module, res_size, res_base2k, res_big, key.base2k)
    return GLWECiphertext(data=res, base2k=res_base2k, k=res_k)


def gglwe_keyswitch(
    module: Module,
    a,                        # GGLWECiphertext
    key: GGLWEPrepared,
    res_base2k: int | None = None,
    res_k: int | None = None,
):
    """GGLWE keyswitch (gglwe_keyswitch_default, keyswitching/gglwe.rs:29-76):
    GLWE-keyswitch every (row, col) sub-ciphertext of the gadget.  The
    reference loops rows × cols_in; here the (dnum, rank_in) axes are batch
    axes of ONE batched glwe_keyswitch call."""
    from poulpy_tpu.core.layouts import GGLWECiphertext

    assert a.rank_out == key.rank_in, (a.rank_out, key.rank_in)
    glwe = GLWECiphertext(data=a.data, base2k=a.base2k, k=a.k)
    ks = glwe_keyswitch(module, glwe, key, res_base2k, res_k)
    return GGLWECiphertext(
        data=ks.data, base2k=ks.base2k, k=ks.k, dsize=a.dsize
    )


def ggsw_keyswitch(
    module: Module,
    a,                        # GGSWCiphertext
    key: GGLWEPrepared,       # switching key s_in -> s_out (rank_in == rank_out)
    tsk,                      # GGLWEToGGSWKey under s_out (list[GGLWEPrepared])
    res_base2k: int | None = None,
    res_k: int | None = None,
):
    """GGSW keyswitch (ggsw_keyswitch_default, keyswitching/ggsw.rs:59-95):
    GLWE-keyswitch column 0 of every gadget row (batched over dnum), then
    regenerate columns 1..rank via the GGLWE→GGSW row expansion with the
    tensor key (ggsw_expand_row)."""
    from poulpy_tpu.core.conversion import ggsw_from_gglwe
    from poulpy_tpu.core.layouts import GGLWECiphertext

    col0 = GLWECiphertext(
        data=a.data[..., :, 0, :, :, :], base2k=a.base2k, k=a.k
    )
    ks = glwe_keyswitch(module, col0, key, res_base2k, res_k)
    gglwe = GGLWECiphertext(
        data=ks.data[..., :, None, :, :, :],
        base2k=ks.base2k,
        k=ks.k,
        dsize=a.dsize,
    )
    return ggsw_from_gglwe(module, gglwe, tsk)


def glwe_normalize(
    module: Module, a: GLWECiphertext, base2k: int, k: int
) -> GLWECiphertext:
    """Base-2^k conversion of a whole ciphertext (GLWENormalize)."""
    size = glwe_size(base2k, k)
    data = vec_znx_normalize_full(size, base2k, 0, a.data, a.base2k)
    return GLWECiphertext(data=data, base2k=base2k, k=k)


def lwe_keyswitch(
    module: Module,
    a,                        # LWECiphertext
    ksk: GGLWEPrepared,       # switching key between embedded LWE secrets
    n_lwe_out: int,
    res_base2k: int | None = None,
    res_k: int | None = None,
):
    """LWE → LWE keyswitch (keyswitching/lwe.rs:49-110): embed the LWE into
    a rank-1 GLWE, GLWE-keyswitch with the LWESwitchingKey (encrypted
    between the φ_{-1}-embedded LWE secrets), extract coefficient 0."""
    import jax.numpy as jnp

    from poulpy_tpu.core.conversion import lwe_sample_extract

    n = module.n
    size = a.size
    batch = a.data.shape[:-2]
    body = jnp.zeros(batch + (size, n), jnp.int64).at[..., :, 0].set(
        a.data[..., :, 0]
    )
    mask = jnp.zeros(batch + (size, n), jnp.int64).at[..., :, : a.n_lwe].set(
        a.data[..., :, 1:]
    )
    glwe = GLWECiphertext(
        data=jnp.stack([body, mask], axis=-3), base2k=a.base2k, k=a.k
    )
    ks = glwe_keyswitch(module, glwe, ksk, res_base2k, res_k)
    return lwe_sample_extract(ks, n_lwe_out, ks.k)


def lwe_switching_key_encrypt_sk(
    module: Module,
    sk_lwe_in,
    sk_lwe_out,
    base2k: int,
    k: int,
    dnum: int,
    source_xe,
    source_xa,
    **kw,
) -> GGLWEPrepared:
    """LWESwitchingKey (encryption/lwe_switching_key.rs): switching key
    between the φ_{-1}-embedded images of two LWE secrets."""
    from poulpy_tpu.core.conversion import lwe_secret_as_glwe
    from poulpy_tpu.core.encryption import glwe_switching_key_encrypt_sk
    from poulpy_tpu.core.prepared import gglwe_prepare, glwe_secret_prepare

    sk_in = lwe_secret_as_glwe(module, sk_lwe_in)
    sk_out = lwe_secret_as_glwe(module, sk_lwe_out)
    sk_out_prep = glwe_secret_prepare(module, sk_out)
    ksk = glwe_switching_key_encrypt_sk(
        module, sk_in, sk_out_prep, base2k, k, dnum, source_xe, source_xa, **kw
    )
    return gglwe_prepare(module, ksk)
