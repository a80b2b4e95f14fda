"""GLWE arithmetic operations (poulpy-core/src/operations/glwe.rs):
add/sub/negate/rotate/shift/normalize plus the tensor product and
relinearization used by CKKS multiplication (glwe.rs:233-545).
"""

from __future__ import annotations

import jax.numpy as jnp

from poulpy_tpu.core.layouts import GLWECiphertext, GLWEPlaintext, glwe_size
from poulpy_tpu.core.prepared import GLWETensorKeyPrepared
from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.normalization import vec_znx_normalize, vec_znx_normalize_full
from poulpy_tpu.hal.vec_znx import (
    vec_znx_add,
    vec_znx_automorphism,
    vec_znx_mul_xp_minus_one,
    vec_znx_rotate,
    vec_znx_sub,
)


def _binary(ct_a: GLWECiphertext, ct_b: GLWECiphertext, op):
    assert ct_a.base2k == ct_b.base2k, "align base2k first (glwe_normalize)"
    k = max(ct_a.k, ct_b.k)
    size = glwe_size(ct_a.base2k, k)
    data = op(ct_a.data, ct_b.data, size)
    return GLWECiphertext(data=data, base2k=ct_a.base2k, k=k)


def glwe_add(a: GLWECiphertext, b: GLWECiphertext) -> GLWECiphertext:
    return _binary(a, b, lambda x, y, s: vec_znx_add(x, y, res_size=s))


def glwe_sub(a: GLWECiphertext, b: GLWECiphertext) -> GLWECiphertext:
    return _binary(a, b, lambda x, y, s: vec_znx_sub(x, y, res_size=s))


def glwe_negate(a: GLWECiphertext) -> GLWECiphertext:
    return a.replace(data=-a.data)


def glwe_add_plain(a: GLWECiphertext, pt: GLWEPlaintext) -> GLWECiphertext:
    assert a.base2k == pt.base2k
    body = vec_znx_add(a.data[..., 0, :, :], pt.data, res_size=a.size)
    return a.replace(data=a.data.at[..., 0, :, :].set(body))


def glwe_sub_plain(a: GLWECiphertext, pt: GLWEPlaintext) -> GLWECiphertext:
    assert a.base2k == pt.base2k
    body = vec_znx_sub(a.data[..., 0, :, :], pt.data, res_size=a.size)
    return a.replace(data=a.data.at[..., 0, :, :].set(body))


def glwe_rotate(p, a: GLWECiphertext) -> GLWECiphertext:
    """ct · X^p (operations/glwe.rs rotate). `p` may be traced/batched."""
    return a.replace(data=vec_znx_rotate(p, a.data))


def ggsw_rotate(p, a):
    """GGSW · X^p (ggsw_rotate_default, operations/ggsw.rs:21-41): rotate
    every (row, col) sub-GLWE — multiplies the GGSW plaintext by X^p.  One
    batched rotate of the whole gadget tensor; `p` may be traced/batched."""
    return a.replace(data=vec_znx_rotate(p, a.data))


def glwe_mul_xp_minus_one(p, a: GLWECiphertext) -> GLWECiphertext:
    """(X^p − 1)·ct — the CGGI accumulator update."""
    return a.replace(data=vec_znx_mul_xp_minus_one(p, a.data))


def glwe_lsh(k_shift: int, a: GLWECiphertext) -> GLWECiphertext:
    """ct · 2^{k_shift} (the CKKS rescale primitive, operations/glwe.rs:1114)."""
    data = vec_znx_normalize_full(a.size, a.base2k, k_shift, a.data, a.base2k)
    return a.replace(data=data)


def glwe_rsh(k_shift: int, a: GLWECiphertext) -> GLWECiphertext:
    data = vec_znx_normalize_full(a.size, a.base2k, -k_shift, a.data, a.base2k)
    return a.replace(data=data)


def glwe_normalize_inplace(a: GLWECiphertext) -> GLWECiphertext:
    return a.replace(data=vec_znx_normalize(a.base2k, a.data))


def glwe_mul_scalar(c: int, a: GLWECiphertext) -> GLWECiphertext:
    """Multiply by a small integer constant, renormalized."""
    return a.replace(data=vec_znx_normalize(a.base2k, a.data * jnp.int64(c)))


# --------------------------------------------------------------------------
# Tensor product + relinearization (CKKS multiplication core)
# --------------------------------------------------------------------------

def glwe_lsh_add(k_shift: int, a: GLWECiphertext, b: GLWECiphertext):
    """res = a·2^k + b (glwe_lsh_add, api/operations.rs)."""
    return glwe_add(glwe_lsh(k_shift, a), b)


def glwe_lsh_sub(k_shift: int, a: GLWECiphertext, b: GLWECiphertext):
    """res = a·2^k − b (glwe_lsh_sub, api/operations.rs)."""
    return glwe_sub(glwe_lsh(k_shift, a), b)


def glwe_mul_plain(
    module: Module, a: GLWECiphertext, pt: GLWEPlaintext,
    res_size: int | None = None,
) -> GLWECiphertext:
    """ct × plaintext polynomial via the bivariate convolution
    (glwe_mul_plain, api/operations.rs → cnv path).  The product's torus
    scale is a.k + pt.k − base2k (the limb convolution shifts one limb up);
    the scheme layer (ckks/ops.py mul_plain) handles meta/budget landing.
    """
    assert a.base2k == pt.base2k
    base2k = a.base2k
    res_size = a.size if res_size is None else res_size
    conv_size = a.size + pt.size - 1
    a_prep = dft.cnv_prepare_left(module, a.data)
    pt_prep = dft.cnv_prepare_right(module, pt.data)
    prod = dft.cnv_apply(module, a_prep, pt_prep, conv_size)
    bits = dft.product_bits(base2k, base2k, module.log_n,
                            min(a.size, pt.size))
    if dft.needs_wide(bits):
        assert bits + 1 < module.basis.modulus.bit_length()
        pair = dft.idft_apply_wide(module, prod)
        data = dft.big_normalize_wide(module, res_size, base2k, pair, base2k)
    else:
        big = dft.idft_apply(module, prod)
        data = dft.big_normalize(module, res_size, base2k, big, base2k)
    return GLWECiphertext(data=data, base2k=base2k,
                          k=min(a.k + pt.k, res_size * base2k))


def glwe_tensor_square_big(module: Module, a: GLWECiphertext,
                           res_size: int, wide: bool = False):
    """Tensor square (glwe_tensor_square_apply, api/operations.rs):
    the a == b special case of glwe_tensor_product_big."""
    return glwe_tensor_product_big(module, a, a, res_size, wide=wide)


def tensor_product_bits(module: Module, a: GLWECiphertext, b: GLWECiphertext) -> int:
    """Exact-value bound (bits) for one tensor-product convolution limb."""
    return dft.product_bits(
        a.base2k, b.base2k, module.log_n, 2 * min(a.size, b.size)
    )


def glwe_tensor_product_big(
    module: Module, a: GLWECiphertext, b: GLWECiphertext, res_size: int,
    wide: bool = False,
):
    """Pairwise bivariate convolution of ciphertext polys
    (glwe_tensor_apply, operations/glwe.rs:233-296 using cnv_apply_dft).

    For rank-1 inputs (a0, a1) ⊗ (b0, b1) returns big-domain
    (d0, d1, d2) = (a0·b0, a0·b1 + a1·b0, a1·b1) — decryptable under
    (1, s, s²).  General rank returns all symmetric products.
    `wide` selects the i128-twin exit (hal/wide.py) for base2k ≳ 26.
    """
    rank = a.rank
    a_prep = dft.cnv_prepare_left(module, a.data)
    b_prep = dft.cnv_prepare_right(module, b.data)
    idft = dft.idft_apply_wide if wide else dft.idft_apply

    def conv(i, j):
        return dft.cnv_apply(
            module, a_prep[..., i, :, :, :], b_prep[..., j, :, :, :], res_size
        )

    terms = {}
    # d_0 = a0 b0 ; d_i = a0 b_i + a_i b0 ; d_{ij} = a_i b_j + a_j b_i (i<j),
    # d_{ii} = a_i b_i
    out = [conv(0, 0)]
    for i in range(1, rank + 1):
        out.append(dft.dft_add(module, conv(0, i), conv(i, 0)))
    for i in range(1, rank + 1):
        for j in range(i, rank + 1):
            t = conv(i, j)
            if i != j:
                t = dft.dft_add(module, t, conv(j, i))
            terms[(i - 1, j - 1)] = t
    lin = [idft(module, x) for x in out]
    quad = {k: idft(module, v) for k, v in terms.items()}
    return lin, quad


def glwe_tensor_relinearize(
    module: Module,
    a: GLWECiphertext,
    b: GLWECiphertext,
    tensor_key: GLWETensorKeyPrepared,
    res_base2k: int | None = None,
    res_k: int | None = None,
) -> GLWECiphertext:
    """Full ct×ct multiply: tensor product then keyswitch each s_i·s_j term
    back to the base key (glwe_tensor_relinearize, operations/glwe.rs:545).

    Scale convention: the bivariate limb convolution shifts the product one
    limb up (value × 2^base2k).  The result is the product of the
    ciphertexts' UNREDUCED values pt + I (I = integer part of Σ c_i·s_i,
    |I| up to ~N/2), so it contains mask-wrap cross terms I_a·pt_b +
    I_b·pt_a above the pt_a·pt_b signal; extracting a usable product
    requires a scale analysis placing those terms below the decode
    precision — see ckks/ops.py mul (off_bits landing shift), the only
    consumer in the reference as well."""
    from poulpy_tpu.core.keyswitching import gglwe_product_dft

    assert a.base2k == b.base2k
    base2k = a.base2k
    res_base2k = base2k if res_base2k is None else res_base2k
    res_k = min(a.k + b.k, a.size * base2k + b.size * base2k) if res_k is None else res_k
    rank = a.rank

    conv_size = a.size + b.size - 1
    any_key = next(iter(tensor_key.keys.values()))
    bits_conv = tensor_product_bits(module, a, b)
    bits_ks = dft.product_bits(
        any_key.base2k, any_key.base2k, module.log_n,
        any_key.dnum * rank * (rank + 1),
    )
    wide = dft.needs_wide(max(bits_conv, bits_ks))
    if wide:
        assert max(bits_conv, bits_ks) + 1 < module.basis.modulus.bit_length()
    res_size = glwe_size(res_base2k, res_k)

    # Normalize the quadratic terms and keyswitch them through the tensor key
    lin, quad = glwe_tensor_product_big(module, a, b, conv_size, wide=wide)
    acc = None
    for (i, j), big in quad.items():
        key = tensor_key.keys[(min(i, j), max(i, j))]
        if wide:
            d = dft.big_normalize_wide(
                module, key.dnum * key.dsize, key.base2k, big, base2k
            )
        else:
            d = dft.big_normalize(
                module, key.dnum * key.dsize, key.base2k, big, base2k
            )
        d_dft = dft.dft_apply(module, d[..., None, :, :])
        part = gglwe_product_dft(module, d_dft, key)
        acc = part if acc is None else dft.dft_add(module, acc, part)

    if wide:
        from poulpy_tpu.hal.wide import wadd

        ks_hi, ks_lo = dft.idft_apply_wide(module, acc)
        hi_cols, lo_cols = [], []
        for c in range(rank + 1):
            ch, cl = ks_hi[..., c, :, :], ks_lo[..., c, :, :]
            ah, al = lin[c]
            m = max(ch.shape[-2], ah.shape[-2])
            ch, ah = dft._align_limbs(ch, ah, m, limb_axis=-2)
            cl, al = dft._align_limbs(cl, al, m, limb_axis=-2)
            nh, nl = wadd(ch, cl, ah, al)
            hi_cols.append(nh)
            lo_cols.append(nl)
        pair = (jnp.stack(hi_cols, axis=-3), jnp.stack(lo_cols, axis=-3))
        data = dft.big_normalize_wide(
            module, res_size, res_base2k, pair, base2k
        )
        return GLWECiphertext(data=data, base2k=res_base2k, k=res_k)

    ks_big = dft.idft_apply(module, acc)  # [..., rank+1, size_key, N]
    # add linear terms: body gets d0, column i gets d_i
    big_cols = []
    for c in range(rank + 1):
        col = ks_big[..., c, :, :]
        add = lin[c]
        m = max(col.shape[-2], add.shape[-2])
        col, add = dft._align_limbs(col, add, m, limb_axis=-2)
        big_cols.append(col + add)
    res_big = jnp.stack(big_cols, axis=-3)
    data = dft.big_normalize(module, res_size, res_base2k, res_big, base2k)
    return GLWECiphertext(data=data, base2k=res_base2k, k=res_k)
