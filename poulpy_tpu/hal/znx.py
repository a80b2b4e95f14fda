"""Z[X]/(X^N+1) coefficient-domain kernels ("znx").

Functional jnp equivalents of the reference scalar kernels in
poulpy-cpu-ref/src/reference/znx/ (arithmetic_ref.rs, rotate.rs,
automorphism.rs, switch_ring.rs).  Polynomials are int64 arrays whose last
axis is N; every op broadcasts over arbitrary leading axes (columns, limbs,
batch), which is how this library batches work the reference does in
scalar loops.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


def znx_add(a, b):
    return a + b


def znx_sub(a, b):
    return a - b


def znx_negate(a):
    return -a


def znx_zero_like(a):
    return jnp.zeros_like(a)


def znx_mul_power_of_two(k: int, a):
    """a · 2^k with wrapping i64 semantics (k may be negative: arithmetic
    right shift).  Mirrors znx_mul_power_of_two_ref
    (poulpy-cpu-ref/src/reference/znx/mul.rs)."""
    if k == 0:
        return a
    if k > 0:
        return a << k
    return a >> (-k)


def znx_rotate(p, a):
    """res = a · X^p in Z[X]/(X^N+1): res[i] = ±a[(i-p) mod N], the sign
    flipping on negacyclic wrap-around.

    Mirrors znx_rotate (poulpy-cpu-ref/src/reference/znx/rotate.rs:3-28) but
    accepts a *traced* rotation amount — `p` may be a Python int, a scalar
    array, or an array broadcastable against `a`'s leading axes (the batched
    blind-rotation path rotates every ciphertext in a batch by a different
    amount in one gather).
    """
    n = a.shape[-1]
    p = jnp.asarray(p, dtype=jnp.int64)
    idx2n = (jnp.arange(n, dtype=jnp.int64) - p[..., None]) & (2 * n - 1)
    sign = jnp.where(idx2n < n, jnp.int64(1), jnp.int64(-1))
    idx = idx2n & (n - 1)
    if p.ndim == 0:
        out = jnp.take(a, idx, axis=-1)
    else:
        bshape = jnp.broadcast_shapes(a.shape[:-1], idx.shape[:-1])
        a_b = jnp.broadcast_to(a, bshape + (n,))
        idx_b = jnp.broadcast_to(idx, bshape + (n,))
        out = jnp.take_along_axis(a_b, idx_b, axis=-1)
    return out * sign


@functools.lru_cache(maxsize=None)
def _automorphism_tables(n: int, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather index + sign realizing X → X^p.

    Host-side transcription of the scatter loop in znx_automorphism_ref
    (poulpy-cpu-ref/src/reference/znx/automorphism.rs:1-17), inverted into a
    gather so the device op is a single take: res[k] = sign[k]·a[idx[k]].
    """
    idx = np.zeros(n, dtype=np.int64)
    sign = np.ones(n, dtype=np.int64)
    mask = 2 * n - 1
    k = 0
    for i in range(1, n):
        k = (k + p) & mask
        if k < n:
            idx[k] = i
            sign[k] = 1
        else:
            idx[k - n] = i
            sign[k - n] = -1
    return idx, sign


def znx_automorphism(p: int, a):
    """res(X) = a(X^p) in Z[X]/(X^N+1). `p` must be a static odd integer."""
    n = a.shape[-1]
    idx, sign = _automorphism_tables(n, int(p) & (2 * n - 1))
    return jnp.take(a, jnp.asarray(idx), axis=-1) * jnp.asarray(sign)


def znx_switch_ring(n_out: int, a):
    """Change ring degree (poulpy-cpu-ref/src/reference/znx/switch_ring.rs):
    downscale keeps every (n_in/n_out)-th coefficient; upscale spreads
    coefficients every (n_out/n_in) slots (X → X^{n_out/n_in} embedding).
    """
    n_in = a.shape[-1]
    if n_out == n_in:
        return a
    if n_out < n_in:
        step = n_in // n_out
        return a[..., ::step]
    gap = n_out // n_in
    out = jnp.zeros(a.shape[:-1] + (n_out,), dtype=a.dtype)
    return out.at[..., ::gap].set(a)
