"""DFT-domain operations: dft/idft, SVP, VMP, bivariate convolution, big ops.

The equivalents of the reference kernels in
poulpy-cpu-ref/src/reference/fft64/{vec_znx_dft.rs, svp.rs, vmp.rs,
vec_znx_big.rs, convolution.rs} (and their ntt120/ exact twins), on the
CRT-NTT domain of `hal.ntt`.

Shape conventions (leading axes broadcast for batching):
  vec_znx       [..., size, N]            int64 limbs
  vec_znx_dft   [..., size, P, N]         int64 residues, standard form
  svp_ppol      [..., P, N]               int64 residues, Montgomery form
  vmp_pmat      [rows, cols_in, cols_out, size, P, N]  Montgomery form
  vec_znx_big   [..., size, N]            int64 wrapping accumulators

The reference's reim4 block-interleaved VmpPMat layout
(poulpy-hal/src/layouts/vmp_pmat.rs:25-33) is an AVX-register artifact and is
deliberately *not* reproduced: the natural `[rows, …, N]` layout lets XLA
tile the contraction directly (SURVEY.md §7 design mapping).
"""

from __future__ import annotations

import jax.numpy as jnp

from poulpy_tpu.hal.module import Module
from poulpy_tpu.hal.normalization import vec_znx_normalize_full
from poulpy_tpu.hal.ntt import (
    fold_mod,
    garner_lift,
    mont_mul,
    ntt_forward,
    ntt_inverse,
    to_mont,
    to_residues,
)
from poulpy_tpu.hal.znx import znx_automorphism


# --------------------------------------------------------------------------
# DFT apply / inverse
# --------------------------------------------------------------------------

def dft_apply(
    module: Module,
    a,
    step: int = 1,
    offset: int = 0,
    res_size: int | None = None,
):
    """vec_znx → vec_znx_dft with (step, offset) limb subsampling.

    res[j] = NTT(a[offset + j·step]) for offset + j·step < a_size, else 0 —
    the gadget-dsize support of vec_znx_dft_apply
    (poulpy-cpu-ref/src/reference/fft64/vec_znx_dft.rs:160-200).
    """
    t = module.tables
    a_size = a.shape[-2]
    steps = -(-a_size // step)
    if res_size is None:
        res_size = steps
    idx = [
        offset + j * step
        for j in range(min(res_size, steps))
        if offset + j * step < a_size
    ]
    r = ntt_forward(t, to_residues(t, a[..., idx, :]))
    if len(idx) < res_size:
        pads = [(0, 0)] * r.ndim
        pads[-3] = (0, res_size - len(idx))
        r = jnp.pad(r, pads)
    return r


def idft_apply(module: Module, a_dft):
    """vec_znx_dft → vec_znx_big: inverse NTT + centered CRT lift.

    Equivalent of vec_znx_idft_apply(_consume)
    (reference/fft64/vec_znx_dft.rs:205+): output is the exact integer
    convolution result as wrapping int64 (the FFT64-family ScalarBig).
    """
    t = module.tables
    return garner_lift(t, ntt_inverse(t, a_dft))


def dft_copy(a_dft, step: int = 1, offset: int = 0, res_size: int | None = None):
    """vec_znx_dft_copy with (step, offset) subsampling
    (reference/fft64/vec_znx_dft.rs:130-158)."""
    a_size = a_dft.shape[-3]
    steps = -(-a_size // step)
    if res_size is None:
        res_size = steps
    limbs = []
    zero = jnp.zeros_like(a_dft[..., 0, :, :])
    for j in range(res_size):
        limb = offset + j * step
        if j < steps and limb < a_size:
            limbs.append(a_dft[..., limb, :, :])
        else:
            limbs.append(zero)
    return jnp.stack(limbs, axis=-3)


def _align_limbs(a, b, res_size, limb_axis=-3):
    """Pad both inputs with zero limbs up to res_size along limb_axis."""
    def pad(x):
        size = x.shape[limb_axis]
        if size == res_size:
            return x
        if size > res_size:
            idx = [slice(None)] * x.ndim
            idx[limb_axis] = slice(0, res_size)
            return x[tuple(idx)]
        pads = [(0, 0)] * x.ndim
        pads[limb_axis % x.ndim] = (0, res_size - size)
        return jnp.pad(x, pads)

    return pad(a), pad(b)


def dft_add(module: Module, a_dft, b_dft, res_size: int | None = None):
    """vec_znx_dft_add semantics (sum over the common limbs, copy the
    longer operand's tail, zero beyond — vec_znx_dft.rs:14-66)."""
    from poulpy_tpu.hal.ntt import add_mod

    p = module.tables.p[:, None]
    if res_size is None:
        res_size = max(a_dft.shape[-3], b_dft.shape[-3])
    a, b = _align_limbs(a_dft, b_dft, res_size)
    return add_mod(a, b, p)


def dft_sub(module: Module, a_dft, b_dft, res_size: int | None = None):
    from poulpy_tpu.hal.ntt import sub_mod

    p = module.tables.p[:, None]
    if res_size is None:
        res_size = max(a_dft.shape[-3], b_dft.shape[-3])
    a, b = _align_limbs(a_dft, b_dft, res_size)
    return sub_mod(a, b, p)


# --------------------------------------------------------------------------
# SVP: prepared scalar-vector products
# --------------------------------------------------------------------------

def svp_prepare(module: Module, s):
    """Scalar poly `[..., N]` → Montgomery NTT form `[..., P, N]`
    (SvpPrepare, reference/fft64/svp.rs)."""
    t = module.tables
    return to_mont(t, ntt_forward(t, to_residues(t, s)))


def svp_apply(module: Module, a_dft, s_ppol):
    """Pointwise product: res[j] = a[j] ⊙ s (SvpApplyDftToDft).

    `a_dft` `[..., size, P, N]`, `s_ppol` `[..., P, N]` (broadcast over limbs).
    """
    t = module.tables
    return mont_mul(
        a_dft, s_ppol[..., None, :, :], t.p[:, None], t.qinv[:, None]
    )


# --------------------------------------------------------------------------
# VMP: prepared vector-matrix products
# --------------------------------------------------------------------------

def vmp_prepare(module: Module, mat):
    """MatZnx `[rows, cols_in, cols_out, size, N]` → prepared Montgomery NTT
    pmat (vmp_prepare, reference/fft64/vmp.rs:52-97, without the reim4
    shuffle — see module docstring)."""
    t = module.tables
    return to_mont(t, ntt_forward(t, to_residues(t, mat)))


def vmp_apply(
    module: Module,
    a_dft,
    pmat,
    limb_offset: int = 0,
    res_size: int | None = None,
):
    """res[..., co, j, p, n] = Σ_{ci, r} a[..., ci, r, p, n] · pmat[r, ci, co,
    j + limb_offset, p, n].

    The hot primitive (vmp_apply_dft_to_dft,
    reference/fft64/vmp.rs:144-264): r ranges over min(rows, a_size) gadget
    rows, ci over input columns; `limb_offset` shifts the output limb window
    (dsize > 1 support).  Sum accumulates lazily in int64 (bound
    rows·cols_in·p < 2^40) with a single final reduction.
    """
    t = module.tables
    rows, cols_in, cols_out, psize = pmat.shape[:4]
    a_size = a_dft.shape[-3]
    assert a_dft.shape[-4] == cols_in
    if res_size is None:
        res_size = psize
    rmax = min(rows, a_size)
    out_cols = max(0, min(psize - limb_offset, res_size))
    if out_cols == 0 or rmax == 0:
        return jnp.zeros(
            a_dft.shape[:-4] + (cols_out, res_size, module.nprimes, module.n),
            a_dft.dtype,
        )
    p = t.p[:, None]
    qinv = t.qinv[:, None]
    acc = None
    for r in range(rmax):
        # a_r: [..., ci, 1, 1, P, N]; pm_r: [ci, co, j, P, N]
        a_r = a_dft[..., :, r, None, None, :, :]
        pm_r = pmat[r, :, :, limb_offset : limb_offset + out_cols]
        prod = mont_mul(a_r, pm_r, p, qinv)
        s = jnp.sum(prod.astype(jnp.int64), axis=-5)  # over ci
        acc = s if acc is None else acc + s
    res = fold_mod(acc, p, t.qinv[:, None], t.r2[:, None]).astype(a_dft.dtype)
    if out_cols < res_size:
        pad = [(0, 0)] * res.ndim
        pad[-3] = (0, res_size - out_cols)
        res = jnp.pad(res, pad)
    return res


# --------------------------------------------------------------------------
# Bivariate convolution (tensor products)
# --------------------------------------------------------------------------

def cnv_prepare_left(module: Module, a):
    """Left operand: standard-form NTT of each limb
    (CnvPVecL, reference/fft64/convolution.rs)."""
    t = module.tables
    return ntt_forward(t, to_residues(t, a))


def cnv_prepare_right(module: Module, b):
    """Right operand: Montgomery-form NTT of each limb (CnvPVecR)."""
    t = module.tables
    return to_mont(t, ntt_forward(t, to_residues(t, b)))


def cnv_apply(module: Module, a_prep, b_prep, res_size: int):
    """res[k] = Σ_{i+j=k} a[i]·b[j] (convolution over the limb index Y with
    negacyclic ring product per term — the bivariate (X, Y) product,
    reference/fft64/convolution.rs).  a standard form, b Montgomery form."""
    t = module.tables
    p = t.p[:, None]
    qinv = t.qinv[:, None]
    a_size = a_prep.shape[-3]
    b_size = b_prep.shape[-3]
    out = []
    for k in range(res_size):
        acc = None
        for i in range(a_size):
            j = k - i
            if 0 <= j < b_size:
                prod = mont_mul(
                    a_prep[..., i, :, :], b_prep[..., j, :, :], p, qinv
                ).astype(jnp.int64)
                acc = prod if acc is None else acc + prod
        if acc is None:
            acc = jnp.zeros(
                jnp.broadcast_shapes(a_prep.shape[:-3], b_prep.shape[:-3])
                + a_prep.shape[-2:],
                a_prep.dtype,
            )
        else:
            acc = fold_mod(acc, p, t.qinv[:, None], t.r2[:, None]).astype(
                a_prep.dtype
            )
        out.append(acc)
    return jnp.stack(out, axis=-3)


# --------------------------------------------------------------------------
# Big-accumulator ops (wrapping int64; reference/fft64/vec_znx_big.rs)
# --------------------------------------------------------------------------

def big_add(a, b, res_size: int | None = None):
    if res_size is None:
        res_size = max(a.shape[-2], b.shape[-2])
    a, b = _align_limbs(a, b, res_size, limb_axis=-2)
    return a + b


def big_sub(a, b, res_size: int | None = None):
    if res_size is None:
        res_size = max(a.shape[-2], b.shape[-2])
    a, b = _align_limbs(a, b, res_size, limb_axis=-2)
    return a - b


def big_automorphism(p: int, a):
    return znx_automorphism(p, a)


def big_normalize(
    module: Module,
    res_size: int,
    res_base2k: int,
    a_big,
    a_base2k: int,
    res_offset: int = 0,
):
    """vec_znx_big_normalize (reference/fft64/vec_znx_big.rs:241-278):
    carry-normalize the big accumulator into limbs, converting base and
    applying a power-of-two offset if requested."""
    del module
    return vec_znx_normalize_full(res_size, res_base2k, res_offset, a_big, a_base2k)


# --------------------------------------------------------------------------
# Wide (i128-twin) big-accumulator mode (hal/wide.py; NTT120 ScalarBig=i128,
# poulpy-cpu-ref/src/ntt120/module.rs:45-46) — for parameter sets whose
# exact convolution values exceed int64 (base2k ≳ 26)
# --------------------------------------------------------------------------

def product_bits(base2k_a: int, base2k_b: int, log_n: int, terms: int) -> int:
    """Upper bound (bits) on |Σ negacyclic products| of `terms` pairs of
    normalized limbs: terms · N · 2^(a−1) · 2^(b−1), plus one sign bit."""
    return (base2k_a - 1) + (base2k_b - 1) + log_n + max(0, terms - 1).bit_length() + 1


def needs_wide(bits: int) -> bool:
    """True when a big-accumulator value bound exceeds the exact int64
    range of `garner_lift` (the FFT64-twin path); the wide path is the
    NTT120 i128 twin."""
    return bits > 62


def idft_apply_wide(module: Module, a_dft):
    """vec_znx_dft → wide big (hi, lo) int64 pairs — idft_apply's i128 twin."""
    from poulpy_tpu.hal.wide import garner_lift_wide

    t = module.tables
    return garner_lift_wide(t, ntt_inverse(t, a_dft))


def big_normalize_wide(
    module: Module,
    res_size: int,
    res_base2k: int,
    pair,
    a_base2k: int,
    res_offset: int = 0,
):
    from poulpy_tpu.hal.wide import vec_znx_normalize_full_wide

    del module
    return vec_znx_normalize_full_wide(
        res_size, res_base2k, res_offset, pair, a_base2k
    )
