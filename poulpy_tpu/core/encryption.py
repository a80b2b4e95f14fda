"""Secret-key encryption for GLWE / GGLWE / GGSW / LWE and the key types.

Mirrors poulpy-core/src/encryption/ (glwe.rs:388-513 internal algorithm,
gglwe.rs:114-150 gadget placement, ggsw.rs per-column plaintext placement,
glwe_switching_key.rs, glwe_automorphism_key.rs, glwe_tensor_key.rs).

Randomness is drawn host-side from the deterministic ChaCha8 `Source`
(whole tensors at once, including batch axes) and the arithmetic runs on
device.  `batch_shape` broadcasts one secret across many plaintexts — the
batched-encryption path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from poulpy_tpu.core.layouts import (
    GGLWECiphertext,
    GGSWCiphertext,
    GLWECiphertext,
    GLWEPlaintext,
    GLWESecret,
    LWECiphertext,
    glwe_size,
)
from poulpy_tpu.core.prepared import GLWESecretPrepared
from poulpy_tpu.hal import dft
from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.normalization import vec_znx_normalize
from poulpy_tpu.hal.source import Source
from poulpy_tpu.hal.vec_znx import vec_znx_sub

DEFAULT_SIGMA_XE = 3.2       # poulpy-core/src/encryption/mod.rs:76
DEFAULT_BOUND_XE = 6.0 * DEFAULT_SIGMA_XE  # mod.rs:80


@dataclass(frozen=True)
class NoiseInfos:
    """poulpy-hal/src/layouts/mod.rs:138-157."""

    k: int
    sigma: float = DEFAULT_SIGMA_XE
    bound: float = DEFAULT_BOUND_XE

    def target_limb_and_scale(self, base2k: int) -> tuple[int, float]:
        limb = -(-self.k // base2k) - 1
        scale = 2.0 ** ((limb + 1) * base2k - self.k)
        return limb, scale


def secret_new(
    module: Module, rank: int, source: Source, dist: str = "ternary_prob", **kw
) -> GLWESecret:
    """Sample a GLWE secret (ScalarZnx fill_* distributions,
    poulpy-hal/src/layouts/scalar_znx.rs:92-170)."""
    n = module.n
    if dist == "ternary_prob":
        data = source.ternary_prob((rank, n), kw.get("prob", 0.5))
    elif dist == "ternary_hw":
        data = np.stack([source.ternary_hw(n, kw["hw"]) for _ in range(rank)])
    elif dist == "binary_prob":
        data = source.binary_prob((rank, n), kw.get("prob", 0.5))
    elif dist == "binary_block":
        data = np.stack(
            [source.binary_block(n, kw["block_size"]) for _ in range(rank)]
        )
    else:
        raise ValueError(dist)
    return GLWESecret(data=jnp.asarray(data), dist=dist)


def _add_noise(c0, base2k: int, noise: NoiseInfos, source: Source):
    """c0 += e at the target limb (vec_znx_add_normal,
    poulpy-cpu-ref/src/reference/vec_znx/sampling.rs:37-56)."""
    limb, scale = noise.target_limb_and_scale(base2k)
    e = source.normal_f64(
        c0.shape[:-2] + (c0.shape[-1],), noise.sigma * scale, noise.bound * scale
    )
    return c0.at[..., limb, :].add(jnp.asarray(e.astype(np.int64)))


import functools

import jax


@functools.partial(
    jax.jit,
    static_argnames=("module", "base2k", "size", "pt_col", "noise_limb"),
)
def _encrypt_core(module, base2k, size, pt_col, noise_limb, mask, e, pt, sk_data):
    """Deterministic encryption arithmetic, jitted once per shape
    (randomness is sampled host-side and passed in)."""
    rank = mask.shape[-3]
    c0 = jnp.zeros(mask.shape[:-3] + mask.shape[-2:], jnp.int64)
    for i in range(1, rank + 1):
        ci = mask[..., i - 1, :, :]
        if pt is not None and pt_col == i:
            ci = vec_znx_normalize(base2k, vec_znx_sub(ci, pt, res_size=size))
        ci_dft = dft.dft_apply(module, ci)
        ci_dft = dft.svp_apply(module, ci_dft, sk_data[i - 1])
        ci_big = dft.idft_apply(module, ci_dft)
        ci_n = dft.big_normalize(module, size, base2k, ci_big, base2k)
        c0 = c0 - ci_n

    c0 = c0.at[..., noise_limb, :].add(e)
    if pt is not None and pt_col == 0:
        c0 = vec_znx_sub(c0, -pt, res_size=size)  # c0 += pt, padded to size
    c0 = vec_znx_normalize(base2k, c0)
    return jnp.concatenate([c0[..., None, :, :], mask], axis=-3)


def encrypt_sk_internal(
    module: Module,
    base2k: int,
    size: int,
    pt,                      # [..., size_pt, N] or None
    pt_col: int,
    sk: GLWESecretPrepared,
    noise: NoiseInfos,
    source_xe: Source,
    source_xa: Source,
    batch_shape: tuple = (),
):
    """The shared encryption core (glwe_encrypt_sk_internal,
    poulpy-core/src/encryption/glwe.rs:426-512).

    Returns `[..., rank+1, size, N]`:
      ct[i≥1] = uniform;  ct[0] = -Σ norm(ct[i]·s_i) + e (+ pt if pt_col=0),
    with pt in column j>0 realized by treating ct[j] as (uniform + pt).
    """
    n = module.n
    rank = sk.rank
    if pt is not None:
        batch_shape = jnp.broadcast_shapes(batch_shape, pt.shape[:-2])

    mask = jnp.asarray(
        source_xa.uniform_digits(base2k, batch_shape + (rank, size, n))
    )
    limb, scale = noise.target_limb_and_scale(base2k)
    e = jnp.asarray(
        source_xe.normal_f64(
            batch_shape + (n,), noise.sigma * scale, noise.bound * scale
        ).astype(np.int64)
    )
    return _encrypt_core(module, base2k, size, pt_col, limb, mask, e, pt, sk.data)


def glwe_encrypt_sk(
    module: Module,
    pt: GLWEPlaintext | None,
    sk: GLWESecretPrepared,
    base2k: int,
    k: int,
    source_xe: Source,
    source_xa: Source,
    sigma: float = DEFAULT_SIGMA_XE,
    bound: float = DEFAULT_BOUND_XE,
    batch_shape: tuple = (),
) -> GLWECiphertext:
    """GLWE sk encryption (GLWEEncryptSkDefault, encryption/glwe.rs:57-162)."""
    size = glwe_size(base2k, k)
    noise = NoiseInfos(k=k, sigma=sigma, bound=bound)
    data = encrypt_sk_internal(
        module,
        base2k,
        size,
        None if pt is None else pt.data,
        0,
        sk,
        noise,
        source_xe,
        source_xa,
        batch_shape,
    )
    return GLWECiphertext(data=data, base2k=base2k, k=k)


def gglwe_encrypt_sk(
    module: Module,
    pt,                      # [rank_in, N] scalar polys
    sk: GLWESecretPrepared,
    base2k: int,
    k: int,
    dnum: int,
    source_xe: Source,
    source_xa: Source,
    dsize: int = 1,
    sigma: float = DEFAULT_SIGMA_XE,
    bound: float = DEFAULT_BOUND_XE,
) -> GGLWECiphertext:
    """GGLWE sk encryption (encryption/gglwe.rs:62-150): row r / input col i
    encrypts pt_i at limb (dsize-1) + r·dsize."""
    size = glwe_size(base2k, k)
    assert dnum * dsize * base2k <= size * base2k
    rank_in = pt.shape[0]
    noise = NoiseInfos(k=k, sigma=sigma, bound=bound)
    n = module.n
    # batch the dnum gadget rows through one jitted encryption per input col
    cols = []
    for i in range(rank_in):
        pt_rows = jnp.zeros((dnum, size, n), jnp.int64)
        for r in range(dnum):
            pt_rows = pt_rows.at[r, (dsize - 1) + r * dsize, :].set(pt[i])
        pt_rows = vec_znx_normalize(base2k, pt_rows)
        cols.append(
            encrypt_sk_internal(
                module, base2k, size, pt_rows, 0, sk, noise,
                source_xe, source_xa,
            )
        )
    data = jnp.stack(cols, axis=1)  # [dnum, rank_in, rank_out+1, size, N]
    return GGLWECiphertext(data=data, base2k=base2k, k=k, dsize=dsize)


def ggsw_encrypt_sk(
    module: Module,
    pt,                      # [N] scalar poly
    sk: GLWESecretPrepared,
    base2k: int,
    k: int,
    dnum: int,
    source_xe: Source,
    source_xa: Source,
    dsize: int = 1,
    sigma: float = DEFAULT_SIGMA_XE,
    bound: float = DEFAULT_BOUND_XE,
) -> GGSWCiphertext:
    """GGSW sk encryption (encryption/ggsw.rs): row r, col j encrypts
    m·s_j·gadget via plaintext placement in ciphertext column j."""
    size = glwe_size(base2k, k)
    rank = sk.rank
    noise = NoiseInfos(k=k, sigma=sigma, bound=bound)
    n = module.n
    pt = jnp.asarray(pt)
    batch = pt.shape[:-1]  # leading batch axes (e.g. n_lwe for BRK keygen)
    pt_rows = jnp.zeros(batch + (dnum, size, n), jnp.int64)
    for r in range(dnum):
        pt_rows = pt_rows.at[..., r, (dsize - 1) + r * dsize, :].set(pt)
    pt_rows = vec_znx_normalize(base2k, pt_rows)
    cols = []
    for j in range(rank + 1):
        cols.append(
            encrypt_sk_internal(
                module, base2k, size, pt_rows, j, sk, noise,
                source_xe, source_xa,
            )
        )
    data = jnp.stack(cols, axis=-4)  # [..., dnum, rank+1, rank+1, size, N]
    return GGSWCiphertext(data=data, base2k=base2k, k=k, dsize=dsize)


# --------------------------------------------------------------------------
# Key-type encryption (wrappers around gglwe_encrypt_sk)
# --------------------------------------------------------------------------

def glwe_switching_key_encrypt_sk(
    module: Module,
    sk_in: GLWESecret,
    sk_out: GLWESecretPrepared,
    base2k: int,
    k: int,
    dnum: int,
    source_xe: Source,
    source_xa: Source,
    dsize: int = 1,
    **kw,
) -> GGLWECiphertext:
    """Key-switching key sk_in → sk_out (encryption/glwe_switching_key.rs)."""
    return gglwe_encrypt_sk(
        module, sk_in.data, sk_out, base2k, k, dnum,
        source_xe, source_xa, dsize=dsize, **kw,
    )


def glwe_automorphism_key_encrypt_sk(
    module: Module,
    p: int,
    sk: GLWESecret,
    base2k: int,
    k: int,
    dnum: int,
    source_xe: Source,
    source_xa: Source,
    dsize: int = 1,
    **kw,
):
    """Automorphism key: encrypts s (as the switching-key input) under the
    permuted secret φ_{p^{-1}}(s) (encryption/glwe_automorphism_key.rs:
    88-107: sk_out = automorphism(galois_element_inv(p), sk), then
    gglwe_encrypt_sk(pt=sk, sk=sk_out)).  Keyswitch + φ_p then yields an
    encryption of φ_p(m) back under s."""
    from poulpy_tpu.core.prepared import glwe_secret_prepare
    from poulpy_tpu.hal.vec_znx import vec_znx_automorphism

    p_inv = pow(int(p) % (2 * module.n), -1, 2 * module.n)
    sk_out = GLWESecret(
        data=vec_znx_automorphism(p_inv, sk.data), dist=sk.dist
    )
    sk_out_prepared = glwe_secret_prepare(module, sk_out)
    key = gglwe_encrypt_sk(
        module, sk.data, sk_out_prepared, base2k, k, dnum,
        source_xe, source_xa, dsize=dsize, **kw,
    )
    return key, p


def glwe_tensor_key_encrypt_sk(
    module: Module,
    sk: GLWESecret,
    sk_prepared: GLWESecretPrepared,
    base2k: int,
    k: int,
    dnum: int,
    source_xe: Source,
    source_xa: Source,
    dsize: int = 1,
    **kw,
) -> dict[tuple[int, int], GGLWECiphertext]:
    """Tensor/relinearization key: for i ≤ j, encrypts s_i·s_j under s
    (encryption/glwe_tensor_key.rs)."""
    rank = sk.rank
    t = module.tables
    keys = {}
    for i in range(rank):
        for j in range(i, rank):
            # exact product s_i·s_j via the NTT (coefficients are tiny)
            si_dft = dft.dft_apply(module, sk.data[i][None, :])
            sj_p = dft.svp_prepare(module, sk.data[j])
            prod = dft.idft_apply(module, dft.svp_apply(module, si_dft, sj_p))
            sisj = prod[0]
            keys[(i, j)] = gglwe_encrypt_sk(
                module, sisj[None, :], sk_prepared, base2k, k, dnum,
                source_xe, source_xa, dsize=dsize, **kw,
            )
    return keys


# --------------------------------------------------------------------------
# LWE
# --------------------------------------------------------------------------

def lwe_encrypt_sk(
    module_unused,
    pt,                      # [..., size, 1] or [..., size] limb scalars
    sk_lwe,                  # [n_lwe] int64
    base2k: int,
    k: int,
    source_xe: Source,
    source_xa: Source,
    sigma: float = DEFAULT_SIGMA_XE,
    bound: float = DEFAULT_BOUND_XE,
) -> LWECiphertext:
    """Scalar LWE encryption (poulpy-core/src/encryption/lwe.rs): body+mask
    packed in one degree-(n+1) row; b = -<a, s> + m + e."""
    n_lwe = sk_lwe.shape[-1]
    size = glwe_size(base2k, k)
    pt = jnp.asarray(pt)
    if pt.shape[-1] != 1:
        pt = pt[..., None]
    batch = pt.shape[:-2]
    a = jnp.asarray(source_xa.uniform_digits(base2k, batch + (size, n_lwe)))
    # body = -Σ a_j s_j + m + e, carried per limb then normalized
    # elementwise mul + reduce: an exact integer dot product, no float
    # matrix unit involved
    body = -(a * jnp.asarray(sk_lwe)).sum(axis=-1)[..., None]
    body = vec_znx_sub(body, -pt[..., :, :], res_size=size)
    noise = NoiseInfos(k=k, sigma=sigma, bound=bound)
    limb, scale = noise.target_limb_and_scale(base2k)
    e = source_xe.normal_f64(batch + (1,), sigma * scale, bound * scale)
    body = body.at[..., limb, :].add(jnp.asarray(e.astype(np.int64)))
    data = jnp.concatenate([body, a], axis=-1)
    data = vec_znx_normalize(base2k, data)
    return LWECiphertext(data=data, base2k=base2k, k=k)


# --------------------------------------------------------------------------
# Public-key encryption (encryption/glwe.rs:166-380, glwe_public_key.rs)
# --------------------------------------------------------------------------

def glwe_public_key_generate(
    module: Module,
    sk: GLWESecretPrepared,
    base2k: int,
    k: int,
    source_xe: Source,
    source_xa: Source,
    **kw,
):
    """GLWEPublicKey = encryption of zero under sk
    (encryption/glwe_public_key.rs)."""
    return glwe_encrypt_sk(module, None, sk, base2k, k, source_xe, source_xa, **kw)


def glwe_public_key_prepare(module: Module, pk: GLWECiphertext):
    """DFT of every pk column (GLWEPrepared for pk encryption)."""
    from poulpy_tpu.hal import dft

    return dft.dft_apply(module, pk.data)


def glwe_encrypt_pk(
    module: Module,
    pt,                      # GLWEPlaintext or None
    pk_prepared,             # [cols, size, P, N] DFT of the public key
    pk_base2k: int,
    pk_k: int,
    source_xu: Source,
    source_xe: Source,
    sigma: float = DEFAULT_SIGMA_XE,
    bound: float = DEFAULT_BOUND_XE,
    u_dist: str = "ternary_prob",
) -> GLWECiphertext:
    """pk encryption (glwe_encrypt_pk_internal, encryption/glwe.rs:330-380):
    sample ephemeral u, ct_i = norm(iDFT(u ⊙ pk_i) + e_i (+ pt at col 0))."""
    from poulpy_tpu.hal import dft

    base2k = pk_base2k
    size = glwe_size(base2k, pk_k)
    cols = pk_prepared.shape[-4]
    n = module.n
    if u_dist == "ternary_prob":
        u = jnp.asarray(source_xu.ternary_prob((n,)))
    elif u_dist == "binary_prob":
        u = jnp.asarray(source_xu.binary_prob((n,)))
    else:
        raise ValueError(u_dist)
    u_dft = dft.svp_prepare(module, u)
    noise = NoiseInfos(k=pk_k, sigma=sigma, bound=bound)
    limb, scale = noise.target_limb_and_scale(base2k)

    out_cols = []
    for i in range(cols):
        ci_dft = dft.svp_apply(module, pk_prepared[..., i, :, :, :], u_dft)
        ci_big = dft.idft_apply(module, ci_dft)
        e = source_xe.normal_f64((n,), sigma * scale, bound * scale)
        ci_big = ci_big.at[..., limb, :].add(jnp.asarray(e.astype(np.int64)))
        if pt is not None and i == 0:
            pt_pad = dft._align_limbs(
                pt.data, ci_big, ci_big.shape[-2], limb_axis=-2
            )[0]
            ci_big = ci_big + pt_pad
        out_cols.append(
            dft.big_normalize(module, size, base2k, ci_big, base2k)
        )
    data = jnp.stack(out_cols, axis=-3)
    return GLWECiphertext(data=data, base2k=base2k, k=pk_k)
