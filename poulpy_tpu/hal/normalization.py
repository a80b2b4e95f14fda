"""Base-2^k carry-propagation normalization.

jnp equivalents of the reference digit/carry kernels
(poulpy-cpu-ref/src/reference/znx/normalization.rs) and the limb-vector
pipelines built on them (poulpy-cpu-ref/src/reference/vec_znx/normalize.rs).

A limb vector `[..., size, N]` represents torus polynomials
    v = Σ_j  x_j · 2^{-(j+1)·base2k}          (limb 0 = most significant).
Normalization rewrites every limb into the balanced digit range
[-2^{base2k-1}, 2^{base2k-1}) by propagating carries from the last limb
(least significant) to the first, discarding the final outgoing carry
(wrap-around mod 1 on the torus).

The general conversion routine (`vec_znx_normalize_full`, covering the
reference's vec_znx_normalize / vec_znx_big_normalize with base change,
resize and power-of-two offset) is implemented data-parallel as *bit-window
telescoping* rather than a port of the reference's sequential
digit-streaming loop (normalize.rs:147-400): every (input limb, output limb)
pair contributes one exact signed bit-window, extracted with two shifts, and
a final carry scan rebalances digits.  This is O(a_size·res_size) fully
vectorized ops with no data-dependent control flow — the shape XLA wants —
and is exact: wrapping-i64 arithmetic makes out-of-range windows cancel.
Truncation convention: bits below the output precision are floored (the
reference rounds-to-nearest via balanced-digit dropping; both are ≤ 1 ulp of
the deepest output limb, see the property tests in
tests/test_hal.py::test_normalize_*).

The scan is sequential in `size` (≤ ~32 static steps, unrolled for XLA
fusion) and fully vectorized over N·cols·batch.
"""

from __future__ import annotations

import jax.numpy as jnp


def get_digit(base2k: int, x):
    """Sign-extended low `base2k` bits of x
    (get_digit_i64, normalization.rs:4-6)."""
    sh = 64 - base2k
    return (x << sh) >> sh


def get_carry(base2k: int, x, digit):
    """(x - digit) >> base2k, arithmetic (get_carry_i64, normalization.rs:9-11)."""
    return (x - digit) >> base2k


def first_step(base2k: int, lsh: int, a):
    """normalization.rs:24-105: lowest limb, no carry in."""
    k = base2k - lsh
    digit = get_digit(k, a)
    carry = get_carry(k, a, digit)
    return digit << lsh, carry


def middle_step(base2k: int, lsh: int, a, c):
    """normalization.rs:107-253: absorb carry, emit carry."""
    k = base2k - lsh
    digit = get_digit(k, a)
    carry = get_carry(k, a, digit)
    digit_plus_c = (digit << lsh) + c
    x1 = get_digit(base2k, digit_plus_c)
    return x1, carry + get_carry(base2k, digit_plus_c, x1)


def final_step(base2k: int, lsh: int, a, c):
    """normalization.rs:254-323: top limb, outgoing carry dropped (mod 1)."""
    k = base2k - lsh
    return get_digit(base2k, (get_digit(k, a) << lsh) + c)


def vec_znx_normalize(base2k: int, a, lsh: int = 0):
    """Same-base same-size normalization of `[..., size, N]`.

    Equivalent of vec_znx_normalize_assign
    (poulpy-cpu-ref/src/reference/vec_znx/normalize.rs:403-425) with the
    reference's first/middle/final schedule plus optional fused `lsh`.
    """
    size = a.shape[-2]
    if size == 1:
        z = jnp.zeros_like(a[..., 0, :])
        return final_step(base2k, lsh, a[..., 0, :], z)[..., None, :]
    out = [None] * size
    x, c = first_step(base2k, lsh, a[..., size - 1, :])
    out[size - 1] = x
    for j in range(size - 2, 0, -1):
        x, c = middle_step(base2k, lsh, a[..., j, :], c)
        out[j] = x
    out[0] = final_step(base2k, lsh, a[..., 0, :], c)
    return jnp.stack(out, axis=-2)


def _shl_wrap(x, s: int):
    """x << s with wrapping i64 semantics for any s ≥ 0 (s ≥ 64 → 0)."""
    if s >= 64:
        return jnp.zeros_like(x)
    return x << s


def _window(d, t: int, kr: int):
    """Signed kr-bit window of d·2^t at bit range [0, kr).

    Telescoped form: (d·2^t mod-high) − 2^kr·(d·2^{t−kr} mod-high), where
    negative shifts are arithmetic (sign-extending, floor).  Result lies in
    (−2^kr, 2^kr) and wrapping arithmetic cancels out-of-range windows.
    """
    def ash(x, s: int):
        if s >= 0:
            return _shl_wrap(x, s)
        return x >> min(-s, 63)

    return ash(d, t) - _shl_wrap(ash(d, t - kr), kr)


def vec_znx_normalize_full(
    res_size: int,
    res_base2k: int,
    res_offset: int,
    a,
    a_base2k: int,
):
    """General normalization: resize, rebase and scale in one pass.

    Writes `a · 2^{res_offset}` (interpreted in base 2^a_base2k, `[..., a_size,
    N]`) as a normalized `[..., res_size, N]` vector in base 2^res_base2k.
    Functional equivalent of vec_znx_normalize
    (poulpy-cpu-ref/src/reference/vec_znx/normalize.rs:18-48) and of
    vec_znx_big_normalize (reference/fft64/vec_znx_big.rs:241-278, which is
    the same routine applied to the i64 big accumulator).

    Exactness: output limb i is the exact signed bit-window of
    Σ_j a_j·2^{-(j+1)·ka+offset} at depth ((i)·kr, (i+1)·kr], with bits below
    depth res_size·kr floored and the value taken mod 1.
    """
    a_size = a.shape[-2]
    kr = res_base2k
    ka = a_base2k
    if res_offset == 0 and kr == ka and res_size == a_size:
        return vec_znx_normalize(kr, a)

    # depth of the LSB of a-limb j (after applying the offset):
    #   D_j = (j+1)·ka − res_offset
    # depth of the LSB of res-limb i:  W_i = (i+1)·kr
    acc = []
    for i in range(res_size):
        w = (i + 1) * kr
        acc_i = None
        for j in range(a_size):
            t = w - ((j + 1) * ka - res_offset)
            piece = _window(a[..., j, :], t, kr)
            acc_i = piece if acc_i is None else acc_i + piece
        acc.append(acc_i)
    return vec_znx_normalize(kr, jnp.stack(acc, axis=-2))
