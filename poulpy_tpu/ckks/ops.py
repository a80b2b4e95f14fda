"""Leveled CKKS operations (poulpy-ckks/src/leveled/).

Meta bookkeeping follows the reference exactly:
  add/sub     → align budgets (error.rs:113-122 checked subs)
  rescale(k)  → glwe_lsh(k); budget -= k (default/rescale.rs:23-73)
  mul         → budget' = min(b1,b2) − max(d1,d2), delta' = min(d1,d2)
                (error.rs:155-175, default/mul.rs:461-478), realized as a
                bivariate-convolution tensor product + tensor-key
                relinearization with a pure bit-shift landing the product at
                the new scale (no modulus switch).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from poulpy_tpu.ckks.encoder import Encoder
from poulpy_tpu.ckks.layouts import CKKSCiphertext, CKKSMeta, CKKSPlaintext
from poulpy_tpu.core import decryption as core_dec
from poulpy_tpu.core import encryption as core_enc
from poulpy_tpu.core.automorphism import glwe_automorphism
from poulpy_tpu.core.layouts import GLWECiphertext, GLWEPlaintext, glwe_size
from poulpy_tpu.core.operations import (
    glwe_add,
    glwe_add_plain,
    glwe_lsh,
    glwe_mul_scalar,
    glwe_negate,
    glwe_sub,
    glwe_sub_plain,
    glwe_tensor_product_big,
)
from poulpy_tpu.core.keyswitching import gglwe_product_dft
from poulpy_tpu.hal import dft, vec_znx
from poulpy_tpu.hal.module import Module


class CKKSError(ValueError):
    """Base class for composition errors (poulpy-ckks/src/error.rs
    CKKSCompositionError).  Subclasses mirror the reference's enum variants
    so callers can match on failure kind."""


class InsufficientHomomorphicCapacity(CKKSError):
    """An operation requires more log_budget than remains (error.rs:20-24)."""

    def __init__(self, op: str, available_log_budget: int, required_bits: int):
        self.op = op
        self.available_log_budget = available_log_budget
        self.required_bits = required_bits
        super().__init__(
            f"{op}: insufficient log_budget "
            f"{available_log_budget} < {required_bits}"
        )


class PlaintextBase2KMismatch(CKKSError):
    """Operands use different limb radices (error.rs:26-30)."""

    def __init__(self, op: str, ct_base2k: int, pt_base2k: int):
        self.op = op
        super().__init__(
            f"{op}: base2k mismatch ct={ct_base2k} vs {pt_base2k}"
        )


class PlaintextAlignmentImpossible(CKKSError):
    """Metadata cannot be aligned into the destination (error.rs:33-38)."""

    def __init__(self, op: str, detail: str):
        self.op = op
        super().__init__(f"{op}: cannot align operands ({detail})")


class MissingAutomorphismKey(CKKSError):
    """A rotation/conjugation key is absent from the key map (error.rs:31)."""

    def __init__(self, op: str, rotation: int):
        self.op = op
        self.rotation = rotation
        super().__init__(f"{op}: no automorphism key for rotation {rotation}")


def _checked_sub(op: str, budget: int, bits: int) -> int:
    if budget < bits:
        raise InsufficientHomomorphicCapacity(op, budget, bits)
    return budget - bits


def encode(
    encoder: Encoder, z, base2k: int, k_ct: int, log_delta: int, log_budget: int
) -> CKKSPlaintext:
    """Slots → CKKSPlaintext limbs at torus precision effective_k."""
    meta = CKKSMeta(log_delta=log_delta, log_budget=log_budget)
    coeffs = encoder.encode(np.asarray(z), log_delta)
    size = glwe_size(base2k, k_ct)
    data = vec_znx.encode_vec_i64(base2k, meta.effective_k, size, jnp.asarray(coeffs))
    return CKKSPlaintext(
        pt=GLWEPlaintext(data=data, base2k=base2k, k=k_ct), meta=meta
    )


def decode(encoder: Encoder, pt: CKKSPlaintext) -> np.ndarray:
    coeffs = np.asarray(
        vec_znx.decode_vec_i64(pt.pt.base2k, pt.meta.effective_k, pt.pt.data)
    )
    return encoder.decode(coeffs, pt.meta.log_delta)


def encrypt_sk(
    module: Module, pt: CKKSPlaintext, sk_prepared, k_ct: int,
    source_xe, source_xa, **kw,
) -> CKKSCiphertext:
    glwe = core_enc.glwe_encrypt_sk(
        module, pt.pt, sk_prepared, pt.pt.base2k, k_ct, source_xe, source_xa, **kw
    )
    return CKKSCiphertext(glwe=glwe, meta=pt.meta)


def decrypt(module: Module, ct: CKKSCiphertext, sk_prepared) -> CKKSPlaintext:
    pt = core_dec.glwe_decrypt(
        module, ct.glwe, sk_prepared, ct.glwe.base2k, ct.meta.effective_k
    )
    return CKKSPlaintext(pt=pt, meta=ct.meta)


def _aligned(a: CKKSCiphertext, b: CKKSCiphertext, op: str):
    """Equalize budgets by shifting the larger-budget operand up
    (ckks_align, default/rescale.rs:73+)."""
    if a.meta.log_delta != b.meta.log_delta:
        raise PlaintextAlignmentImpossible(op, "log_delta mismatch")
    if a.log_budget == b.log_budget:
        return a, b
    if a.log_budget > b.log_budget:
        a = rescale(a, a.log_budget - b.log_budget)
    else:
        b = rescale(b, b.log_budget - a.log_budget)
    return a, b


def add(a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
    a, b = _aligned(a, b, "add")
    return CKKSCiphertext(glwe=glwe_add(a.glwe, b.glwe), meta=a.meta)


def sub(a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
    a, b = _aligned(a, b, "sub")
    return CKKSCiphertext(glwe=glwe_sub(a.glwe, b.glwe), meta=a.meta)


def negate(a: CKKSCiphertext) -> CKKSCiphertext:
    return CKKSCiphertext(glwe=glwe_negate(a.glwe), meta=a.meta)


def add_plain(a: CKKSCiphertext, pt: CKKSPlaintext) -> CKKSCiphertext:
    if pt.meta.effective_k != a.meta.effective_k or pt.meta.log_delta != a.meta.log_delta:
        raise PlaintextAlignmentImpossible("add_plain", "meta mismatch")
    return CKKSCiphertext(glwe=glwe_add_plain(a.glwe, pt.pt), meta=a.meta)


def sub_plain(a: CKKSCiphertext, pt: CKKSPlaintext) -> CKKSCiphertext:
    if pt.meta.effective_k != a.meta.effective_k or pt.meta.log_delta != a.meta.log_delta:
        raise PlaintextAlignmentImpossible("sub_plain", "meta mismatch")
    return CKKSCiphertext(glwe=glwe_sub_plain(a.glwe, pt.pt), meta=a.meta)


def mul_pow2(a: CKKSCiphertext, bits: int) -> CKKSCiphertext:
    """ct · 2^bits (ckks_mul_pow2_into_default, leveled/default/pow2.rs:26):
    a pure limb shift; the message scales by 2^bits at fixed
    (log_delta, log_budget).  The reference's `offset` term handles
    destination-layout mismatch, which the functional API has no analogue
    of (the result inherits the operand's layout)."""
    return CKKSCiphertext(glwe=glwe_lsh(bits, a.glwe), meta=a.meta)


def div_pow2(a: CKKSCiphertext, bits: int) -> CKKSCiphertext:
    """ct / 2^bits (ckks_div_pow2_into_default, leveled/default/pow2.rs:58):
    no data movement — the scale is re-declared (log_delta += bits,
    log_budget -= bits), so the same torus value decodes as m/2^bits."""
    budget = _checked_sub("div_pow2", a.log_budget, bits)
    return CKKSCiphertext(
        glwe=a.glwe,
        meta=CKKSMeta(log_delta=a.meta.log_delta + bits, log_budget=budget),
    )


def rescale(a: CKKSCiphertext, k: int) -> CKKSCiphertext:
    """ct·2^k with budget -= k (pure bit shift, default/rescale.rs:23-37)."""
    budget = _checked_sub("rescale", a.log_budget, k)
    return CKKSCiphertext(
        glwe=glwe_lsh(k, a.glwe),
        meta=CKKSMeta(log_delta=a.meta.log_delta, log_budget=budget),
    )


def _truncate_to_eff(data, base2k: int, eff_k: int):
    """Truncate a limb tensor [..., size, N] to EXACTLY eff_k bits of torus
    precision: keep ceil(eff_k/base2k) limbs and MSB-mask the bottom limb
    (msb_mask_bottom_limb, poulpy-core/src/operations/glwe.rs:921-926; the
    reference's tensor/mul_plain paths assert operands arrive at effective
    size, glwe.rs:208-217).

    Load-bearing for ct×ct: with operands exact multiples of 2^-eff, every
    mask-wrap cross term (I·v, I·I — CLAUDE.md) becomes an integer under
    the landing shift and wraps away EXACTLY mod 1.  Convolving the full
    limb tail instead leaks I·noise terms scaled 2^{off−k} into the result
    (regression: tests/test_ckks.py::test_mul_many_balanced_tree — product
    cts and short-k cts decoded garbage)."""
    size = -(-eff_k // base2k)
    # eff_k beyond the stored limbs would make the slice a no-op and the
    # .at[size-1] mask clamp onto the WRONG limb — fail loudly
    assert size <= data.shape[-2], (
        f"effective_k={eff_k} needs {size} limbs, ct stores {data.shape[-2]}"
    )
    d = data[..., :size, :]
    r = eff_k % base2k
    if r:
        mask = (-1) << (base2k - r)
        d = d.at[..., size - 1, :].set(d[..., size - 1, :] & mask)
    return d


@functools.partial(jax.jit, static_argnames=("module", "res_k"))
def mul(
    module: Module,
    a: CKKSCiphertext,
    b: CKKSCiphertext,
    tensor_key,
    res_k: int | None = None,
) -> CKKSCiphertext:
    """ct × ct with relinearization (default/mul.rs:25-120).

    The torus product A·B (exact bivariate convolution of the operands
    truncated to their effective precision) is landed at the new scale with
    a single power-of-two offset inside the final normalization — the
    bit-shift rescale that replaces RNS modswitching.
    """
    if module.mesh is not None:
        from poulpy_tpu.parallel.auto import dp_shard

        return dp_shard(
            module,
            lambda a_, b_: mul(module.local, a_, b_, tensor_key, res_k),
            a, b,
        )
    ga, gb = a.glwe, b.glwe
    if ga.base2k != gb.base2k:
        raise PlaintextBase2KMismatch("mul", ga.base2k, gb.base2k)
    base2k = ga.base2k
    res_k = max(ga.k, gb.k) if res_k is None else res_k
    # operands enter the convolution at effective precision (see
    # _truncate_to_eff; ckks_mul_into passes effective_k through to
    # glwe_tensor_apply, leveled/default/mul.rs:70-78)
    ga = GLWECiphertext(
        data=_truncate_to_eff(ga.data, base2k, a.meta.effective_k),
        base2k=base2k, k=min(ga.k, -(-a.meta.effective_k // base2k) * base2k),
    )
    gb = GLWECiphertext(
        data=_truncate_to_eff(gb.data, base2k, b.meta.effective_k),
        base2k=base2k, k=min(gb.k, -(-b.meta.effective_k // base2k) * base2k),
    )

    d1, d2 = a.meta.log_delta, b.meta.log_delta
    b1, b2 = a.meta.log_budget, b.meta.log_budget
    res_budget = _checked_sub("mul", min(b1, b2), max(d1, d2))
    res_delta = min(d1, d2)
    res_offset = max(0, (res_budget + res_delta) - res_k)
    res_budget = _checked_sub("mul", res_budget, res_offset)
    e_res = res_budget + res_delta

    # off_bits: v_res = (A·B)·2^{e_a+e_b − max(d) − e_res − res_offset...}
    off_bits = (a.effective_k + b.effective_k) - max(d1, d2) - e_res
    res_size = glwe_size(base2k, res_k)
    rank = ga.rank

    conv_size = ga.size + gb.size - 1
    from poulpy_tpu.core.operations import tensor_product_bits

    any_key = next(iter(tensor_key.keys.values()))
    bits = max(
        tensor_product_bits(module, ga, gb),
        dft.product_bits(any_key.base2k, any_key.base2k, module.log_n,
                         any_key.dnum * rank * (rank + 1)),
    )
    wide = dft.needs_wide(bits)  # NTT120-twin exit for base2k ≳ 26 params
    if wide:
        assert bits + 1 < module.basis.modulus.bit_length()

    norm = dft.big_normalize_wide if wide else dft.big_normalize
    lin, quad = glwe_tensor_product_big(module, ga, gb, conv_size, wide=wide)

    # relinearize quadratic terms with the offset applied inside the
    # decomposition normalization (keyswitch is linear, so the power-of-two
    # landing shift happens before digit decomposition to keep precision)
    acc = None
    for (i, j), big in quad.items():
        key = tensor_key.keys[(min(i, j), max(i, j))]
        d = norm(
            module, key.dnum * key.dsize, key.base2k, big, base2k,
            res_offset=off_bits - base2k,
        )
        d_dft = dft.dft_apply(module, d[..., None, :, :])
        part = gglwe_product_dft(module, d_dft, key)
        acc = part if acc is None else dft.dft_add(module, acc, part)

    if wide:
        from poulpy_tpu.hal.wide import wadd, wfrom_i64

        ks_hi, ks_lo = dft.idft_apply_wide(module, acc)
        lin_shifted = [
            norm(module, ks_hi.shape[-2], base2k, t, base2k,
                 res_offset=off_bits - base2k)
            for t in lin
        ]
        hi_cols, lo_cols = [], []
        for c in range(rank + 1):
            ah, al = wfrom_i64(lin_shifted[c])
            nh, nl = wadd(ks_hi[..., c, :, :], ks_lo[..., c, :, :], ah, al)
            hi_cols.append(nh)
            lo_cols.append(nl)
        data = dft.big_normalize_wide(
            module, res_size, base2k,
            (jnp.stack(hi_cols, axis=-3), jnp.stack(lo_cols, axis=-3)),
            base2k,
        )
        glwe = GLWECiphertext(data=data, base2k=base2k, k=res_k)
        return CKKSCiphertext(
            glwe=glwe, meta=CKKSMeta(log_delta=res_delta, log_budget=res_budget)
        )

    ks_big = dft.idft_apply(module, acc)
    # linear terms with the same landing shift
    lin_shifted = [
        dft.big_normalize(
            module, ks_big.shape[-2], base2k, t, base2k,
            res_offset=off_bits - base2k,
        )
        for t in lin
    ]
    cols = []
    for c in range(rank + 1):
        col = ks_big[..., c, :, :]
        add_t = lin_shifted[c]
        m_size = max(col.shape[-2], add_t.shape[-2])
        col, add_t = dft._align_limbs(col, add_t, m_size, limb_axis=-2)
        cols.append(col + add_t)
    res_big = jnp.stack(cols, axis=-3)
    data = dft.big_normalize(module, res_size, base2k, res_big, base2k)
    glwe = GLWECiphertext(data=data, base2k=base2k, k=res_k)
    return CKKSCiphertext(
        glwe=glwe, meta=CKKSMeta(log_delta=res_delta, log_budget=res_budget)
    )


def mul_plain(
    module: Module, a: CKKSCiphertext, pt: CKKSPlaintext
) -> CKKSCiphertext:
    """ct × pt (default/mul.rs get_mul_pt_params: budget' = b_a − d_pt,
    delta' = d_a  — the plaintext's scale is divided out)."""
    ga = a.glwe
    if ga.base2k != pt.pt.base2k:
        raise PlaintextBase2KMismatch("mul_plain", ga.base2k, pt.pt.base2k)
    base2k = ga.base2k
    res_budget = _checked_sub("mul_plain", a.log_budget, pt.meta.log_delta)
    res_delta = a.meta.log_delta
    e_res = res_budget + res_delta
    off_bits = (a.effective_k + pt.meta.effective_k) - pt.meta.log_delta - e_res

    # both operands at effective precision (reference glwe_mul_plain MSB
    # masks, operations/glwe.rs:217-221 — see _truncate_to_eff)
    ct_data = _truncate_to_eff(ga.data, base2k, a.meta.effective_k)
    pt_data = _truncate_to_eff(pt.pt.data, base2k, pt.meta.effective_k)
    pt_prep = dft.cnv_prepare_right(module, pt_data)
    ct_prep = dft.cnv_prepare_left(module, ct_data)
    conv_size = ct_data.shape[-2] + pt_data.shape[-2] - 1
    prod = dft.cnv_apply(module, ct_prep, pt_prep, conv_size)
    bits = dft.product_bits(
        base2k, base2k, module.log_n, min(ga.size, pt.pt.size)
    )
    if dft.needs_wide(bits):
        assert bits + 1 < module.basis.modulus.bit_length()
        pair = dft.idft_apply_wide(module, prod)
        data = dft.big_normalize_wide(
            module, ga.size, base2k, pair, base2k,
            res_offset=off_bits - base2k,
        )
    else:
        big = dft.idft_apply(module, prod)
        data = dft.big_normalize(
            module, ga.size, base2k, big, base2k, res_offset=off_bits - base2k
        )
    glwe = GLWECiphertext(data=data, base2k=base2k, k=ga.k)
    return CKKSCiphertext(
        glwe=glwe, meta=CKKSMeta(log_delta=res_delta, log_budget=res_budget)
    )


def rotate(
    module: Module, a: CKKSCiphertext, auto_key, steps_unused: int = 0
) -> CKKSCiphertext:
    """Slot rotation by r = automorphism X → X^{5^r}
    (default/rotate.rs); the key's galois element determines r."""
    glwe = glwe_automorphism(module, a.glwe, auto_key, a.glwe.base2k, a.glwe.k)
    return CKKSCiphertext(glwe=glwe, meta=a.meta)


def rotate_by(
    module: Module, a: CKKSCiphertext, key_map: dict, r: int
) -> CKKSCiphertext:
    """Slot rotation by `r` with a key map {r: automorphism key}
    (default/rotate.rs keyed path; raises MissingAutomorphismKey as
    error.rs:31 when the requested rotation has no key)."""
    if r not in key_map:
        raise MissingAutomorphismKey("rotate", r)
    return rotate(module, a, key_map[r])


def conjugate(module: Module, a: CKKSCiphertext, auto_key) -> CKKSCiphertext:
    """Complex conjugation = automorphism X → X^{-1} (default/conjugate.rs)."""
    glwe = glwe_automorphism(module, a.glwe, auto_key, a.glwe.base2k, a.glwe.k)
    return CKKSCiphertext(glwe=glwe, meta=a.meta)


# ---- composite ops (leveled/api/composite.rs:28-235) ----------------------

def add_many(cts: list[CKKSCiphertext]) -> CKKSCiphertext:
    out = cts[0]
    for c in cts[1:]:
        out = add(out, c)
    return out


def mul_add(module, a, b, c, tensor_key):
    """res = a·b + c."""
    return add(mul(module, a, b, tensor_key), c)


def mul_sub(module, a, b, c, tensor_key):
    return sub(mul(module, a, b, tensor_key), c)


def dot_product(module, xs, ys, tensor_key):
    """Σ x_i·y_i (composite.rs dot_product)."""
    return add_many([mul(module, x, y, tensor_key) for x, y in zip(xs, ys)])


def mul_many(
    module, cts: list[CKKSCiphertext], tensor_key, res_k: int | None = None
) -> CKKSCiphertext:
    """Balanced-binary-tree product of n ciphertexts
    (leveled/api/composite.rs:45-51, recursion in delegates/composite.rs
    mul_many_rec:107-165): depth ⌈log2 n⌉ sequential muls instead of the
    left fold's n−1 — ⌈log2 n⌉·Δ budget spent instead of (n−1)·Δ, and the
    shorter critical path is also the jit-friendly shape (the tree's
    independent muls batch/parallelize where a fold cannot).

    Intermediate products are TRUNCATED to the subtree's surviving
    precision, k_sub = min_eff_k − ⌈log2 n_sub⌉·Δ, exactly as the reference
    allocates its left/right scratch GLWEs (composite.rs:136-152).  This is
    load-bearing, not an optimization: the raw tensor product's mask-wrap
    cross terms (I·noise, see CLAUDE.md) land BELOW e_res but inside a
    full-k ciphertext, and feeding such a ct into the next level poisons it
    — with k_sub = eff_k the landing shift of the next mul is ≥ the
    operand's quantization depth, so every integer-part cross term wraps
    away mod 1 exactly."""
    if not cts:
        raise ValueError("mul_many: inputs must contain at least one ct")
    if any(c.meta.log_delta != cts[0].meta.log_delta for c in cts):
        raise ValueError("mul_many: all inputs must share log_delta")
    if len(cts) == 1:
        return cts[0]
    if len(cts) == 2:
        return mul(module, cts[0], cts[1], tensor_key, res_k=res_k)
    log_delta = cts[0].meta.log_delta

    def branch(sub):
        if len(sub) == 1:
            return sub[0]
        sub_k = (min(c.meta.effective_k for c in sub)
                 - (len(sub) - 1).bit_length() * log_delta)
        return mul_many(module, sub, tensor_key, res_k=sub_k)

    mid = len(cts) // 2
    left = branch(cts[:mid])
    right = branch(cts[mid:])
    return mul(module, left, right, tensor_key, res_k=res_k)


def mul_const(a: CKKSCiphertext, c: float, log_delta_c: int) -> CKKSCiphertext:
    """ct × scalar constant (CKKSPlaintextCstRnx path,
    poulpy-ckks/src/layouts/plaintext/cst.rs + default/mul.rs const-mul):
    multiply limbs by round(c·2^{log_delta_c}), divide the scale back out of
    the budget."""
    ci = int(round(c * (1 << log_delta_c)))
    budget = _checked_sub("mul_const", a.log_budget, log_delta_c)
    # multiplying the limbs by round(c·2^{log_delta_c}) grows the torus
    # value by exactly 2^{log_delta_c}; the budget decrement IS that scale
    # landing (effective_k drops by log_delta_c) — no extra shift, or the
    # constant's scale would be divided out twice (regression:
    # tests/test_ckks.py::test_mul_add_const_scalar).
    glwe = glwe_mul_scalar(ci, a.glwe)
    return CKKSCiphertext(
        glwe=glwe,
        meta=CKKSMeta(log_delta=a.meta.log_delta, log_budget=budget),
    )


def add_const(a: CKKSCiphertext, c: float) -> CKKSCiphertext:
    """ct + scalar constant (CstRnx add): adds c·Δ to the body's constant
    slot-broadcast (all slots shift by c — the encoder maps a constant to the
    degree-0 coefficient)."""
    # the ct encodes slot values as integers c·2^{log_delta} at torus
    # precision effective_k; a constant must enter at the SAME scale
    # (regression: tests/test_ckks.py::test_mul_add_const_scalar)
    ci = int(round(c * (1 << a.meta.log_delta)))
    size = a.glwe.size
    base2k = a.glwe.base2k
    import jax.numpy as jnp

    from poulpy_tpu.hal.vec_znx import encode_vec_i64

    n = a.glwe.n
    coeffs = jnp.zeros((n,), jnp.int64).at[0].set(1)
    pt = encode_vec_i64(base2k, a.meta.effective_k, size, coeffs * ci)
    data = a.glwe.data.at[..., 0, :, :].add(pt)
    return a.replace(glwe=a.glwe.replace(data=data))
