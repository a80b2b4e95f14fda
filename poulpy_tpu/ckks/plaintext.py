"""CKKS plaintext forms (poulpy-ckks/src/layouts/plaintext/).

The reference distinguishes four plaintext representations:
  VecRnx  — float coefficient polynomial, pre-quantization (vec.rs:21)
  VecZnx  — quantized torus-limb polynomial (vec.rs:24; the repo's
            ``CKKSPlaintext`` in ckks/layouts.py)
  CstRnx  — float scalar constant re + im·i (cst.rs:13)
  CstZnx  — quantized scalar constant (cst.rs:42)

This module adds the float-side forms and their conversions
(CKKSPlaintextConversion / CKKSConstPlaintextConversion, vec.rs:160-196,
cst.rs:71-120) plus the ct×pt mul entry points that consume them
(leveled/default/mul.rs:295-341 vec_rnx path, :343-456 cst paths).
Quantization is host-side numpy (prepare step); the multiply itself rides
the existing convolution / scalar paths.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from poulpy_tpu.ckks.layouts import CKKSCiphertext, CKKSMeta, CKKSPlaintext
from poulpy_tpu.core.layouts import GLWEPlaintext, glwe_size
from poulpy_tpu.hal import vec_znx
from poulpy_tpu.hal.module import Module
from poulpy_tpu.utils import struct


def _static(**kw):
    return struct.field(pytree_node=False, **kw)


@struct.dataclass
class CKKSPlaintextVecRnx:
    """Float coefficient polynomial before quantization (vec.rs:21).
    Typically produced/consumed by the slot encoder; leading axes batch."""

    coeffs: jnp.ndarray  # f64 [..., N]

    @property
    def n(self) -> int:
        return self.coeffs.shape[-1]


@struct.dataclass
class CKKSPlaintextCstRnx:
    """Scalar constant re + im·i in float form (cst.rs:13); either part
    optional so real-only constants skip the imaginary work entirely."""

    re: float | None = _static(default=None)
    im: float | None = _static(default=None)


@struct.dataclass
class CKKSPlaintextCstZnx:
    """Quantized scalar constant (cst.rs:42): the integers
    round(re·2^log_delta), round(im·2^log_delta) plus their meta."""

    re: int | None = _static(default=None)
    im: int | None = _static(default=None)
    meta: CKKSMeta = _static(default=None)


# ---- conversions (vec.rs to_znx/decode_from_znx :273-305) -----------------

def vec_rnx_to_znx(
    pt: CKKSPlaintextVecRnx, base2k: int, k_pt: int, meta: CKKSMeta
) -> CKKSPlaintext:
    """Quantize: digits of round(coeffs · 2^log_delta) at torus precision
    effective_k (vec.rs to_znx:273-289; i64 path — effective_k ≤ 62 holds
    for every repo config, the reference's i128 branch is the >63 case)."""
    if meta.effective_k > 62:
        raise ValueError("effective_k > 62 needs the wide encode path")
    q = np.rint(np.asarray(pt.coeffs, np.float64)
                * float(2.0 ** meta.log_delta)).astype(np.int64)
    size = glwe_size(base2k, k_pt)
    data = vec_znx.encode_vec_i64(
        base2k, meta.effective_k, size, jnp.asarray(q)
    )
    return CKKSPlaintext(
        pt=GLWEPlaintext(data=data, base2k=base2k, k=k_pt), meta=meta
    )


def vec_rnx_from_znx(pt: CKKSPlaintext) -> CKKSPlaintextVecRnx:
    """Dequantize back to float coefficients (vec.rs decode_from_znx)."""
    q = vec_znx.decode_vec_i64(pt.pt.base2k, pt.meta.effective_k, pt.pt.data)
    coeffs = jnp.asarray(q, jnp.float64) / float(2.0 ** pt.meta.log_delta)
    return CKKSPlaintextVecRnx(coeffs=coeffs)


def cst_rnx_to_znx(
    cst: CKKSPlaintextCstRnx, meta: CKKSMeta
) -> CKKSPlaintextCstZnx:
    """Quantize a scalar constant (cst.rs to_znx:71-99)."""
    s = 2.0 ** meta.log_delta
    return CKKSPlaintextCstZnx(
        re=None if cst.re is None else int(round(cst.re * s)),
        im=None if cst.im is None else int(round(cst.im * s)),
        meta=meta,
    )


# ---- ct × pt entry points -------------------------------------------------

def mul_plain_rnx(
    module: Module,
    a: CKKSCiphertext,
    pt_rnx: CKKSPlaintextVecRnx,
    meta: CKKSMeta,
) -> CKKSCiphertext:
    """ct × float-polynomial plaintext (ckks_mul_pt_vec_rnx_into,
    default/mul.rs:295-317): quantize to VecZnx at `meta`, then the generic
    convolution ct×pt path."""
    from poulpy_tpu.ckks.ops import mul_plain

    # minimum storage implied by meta (the reference's prec.min_k(base2k))
    pt = vec_rnx_to_znx(pt_rnx, a.glwe.base2k, meta.effective_k, meta)
    return mul_plain(module, a, pt)


def mul_cst_znx(
    module: Module, a: CKKSCiphertext, cst: CKKSPlaintextCstZnx
) -> CKKSCiphertext:
    """ct × quantized scalar constant (ckks_mul_pt_const_znx_into,
    default/mul.rs:343-376): re·ct plus X^{N/2}·(im·ct) — multiplication by
    i in the slot domain is the rotation by N/2 (ζ^{N/2} = i)."""
    from poulpy_tpu.ckks.ops import _checked_sub
    from poulpy_tpu.core.operations import (
        glwe_add,
        glwe_mul_scalar,
        glwe_rotate,
    )

    meta = cst.meta
    budget = _checked_sub("mul_cst_znx", a.log_budget, meta.log_delta)
    if cst.re is None and cst.im is None:
        glwe = a.glwe.replace(data=jnp.zeros_like(a.glwe.data))
    elif cst.im is None:
        glwe = glwe_mul_scalar(cst.re, a.glwe)
    elif cst.re is None:
        glwe = glwe_rotate(a.glwe.n // 2, glwe_mul_scalar(cst.im, a.glwe))
    else:
        glwe = glwe_add(
            glwe_mul_scalar(cst.re, a.glwe),
            glwe_rotate(a.glwe.n // 2, glwe_mul_scalar(cst.im, a.glwe)),
        )
    # the integer multiply IS the scale landing: effective_k drops by the
    # constant's log_delta through the budget decrement (see ops.mul_const)
    return CKKSCiphertext(
        glwe=glwe,
        meta=CKKSMeta(log_delta=a.meta.log_delta, log_budget=budget),
    )


def mul_cst_rnx(
    module: Module,
    a: CKKSCiphertext,
    cst: CKKSPlaintextCstRnx,
    meta: CKKSMeta,
) -> CKKSCiphertext:
    """ct × float scalar constant (ckks_mul_pt_const_rnx_into,
    default/mul.rs:411-434): quantize then the CstZnx path."""
    return mul_cst_znx(module, a, cst_rnx_to_znx(cst, meta))
