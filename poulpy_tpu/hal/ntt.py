"""Exact negacyclic NTT over a CRT prime basis + Montgomery arithmetic.

This is the single DFT domain replacing both reference families:
  * FFT64's `reim` f64 FFT (poulpy-cpu-ref/src/reference/fft64/reim/fft_ref.rs:25-43)
    — float rounding would make device results depend on summation order,
    and
  * NTT120's 4×~30-bit-prime CRT NTT (poulpy-cpu-ref/src/reference/ntt120/ntt.rs:558,617)
    — same mathematical idea, but re-derived here in Montgomery form with
    R = 2^30 rather than the reference's Q120 layout.

All kernels are pure `jnp` int64 and shape-polymorphic: residue tensors are
`[..., P, N]` with P = number of primes, N = ring degree.  XLA compiles them
for the CPU (tests) and the GPU (the device path) alike; both are exact, so
their results are bit-identical.

Values in the NTT domain are kept in *standard* residue form `[0, p)`;
prepared operands (twiddles, SVP/VMP matrices) are stored in *Montgomery*
form `b·R mod p` so a single REDC per product returns a standard-form
result: REDC(a · bR) = a·b mod p.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from poulpy_tpu.hal.primes import MASK30, MASK32, PrimeBasis

I64 = jnp.int64


# --------------------------------------------------------------------------
# Modular scalar kernels (vectorized; p/qinv broadcast along trailing dims)
# --------------------------------------------------------------------------

def mont_mul(a, b_mont, p, qinv):
    """REDC_{R=2^30}(a · b_mont) = a·b mod p, for 0 ≤ a,b < p < 2^30.

    t + m·p < 2^60 + 2^60 stays in signed int64.
    Accepts int32 or int64 operands; result has the dtype of `a`.
    """
    dt = a.dtype if hasattr(a, "dtype") else jnp.int64
    t = a.astype(I64) * b_mont.astype(I64)
    m = ((t & MASK30) * jnp.asarray(qinv, I64)) & MASK30
    u = (t + m * jnp.asarray(p, I64)) >> 30
    return jnp.where(u >= p, u - p, u).astype(dt)


def add_mod(a, b, p):
    pa = jnp.asarray(p).astype(a.dtype)  # avoid silent i32→i64 promotion
    s = a + b
    return jnp.where(s >= pa, s - pa, s)


def sub_mod(a, b, p):
    pa = jnp.asarray(p).astype(a.dtype)
    d = a - b
    return jnp.where(d < 0, d + pa, d)


def neg_mod(a, p):
    pa = jnp.asarray(p).astype(a.dtype)
    return jnp.where(a == 0, a, pa - a)


def mul_mod(a, b, p):
    """Plain (a·b) mod p for 0 ≤ a,b < p < 2^30 (non-Montgomery)."""
    return (a * b) % p


def fold_mod(acc, p, qinv, r2):
    """Non-negative int64 accumulator (< 2^59) → [0, p), division-free:
    one REDC then ·R²·R^{-1}."""
    m = ((acc & MASK30) * qinv) & MASK30
    u = (acc + m * p) >> 30
    for _ in range(3):
        u = jnp.where(u >= p, u - p, u)
    return mont_mul(u, r2, p, qinv)


def reduce_i64(x, p, qinv, r2, t40):
    """Any signed int64 → residue in [0, p), division-free.

    Avoids int64 `%` (a long-division sequence on every backend).
    Two-stage fold instead: (1) x = x_hi·2^40 + x_lo with x_lo the unsigned
    low 40 bits folds to |y| < 2^55; (2) offset by the p-multiple p·2^29 to
    make it non-negative, one REDC (→ x·R^{-1} mod p, < 2^31), three
    conditional subtracts, then ·R²·R^{-1} cancels the stray R^{-1}.
    Reference analogue: reim_from_znx (reference/fft64/reim/conversion.rs).
    """
    x_lo = x & ((1 << 40) - 1)
    x_hi = x >> 40                  # signed, |x_hi| < 2^24
    y = x_hi * t40 + x_lo           # ≡ x (mod p), |y| < 2^55
    yp = y + (p << 29)              # > 0, < 2^59 < p·R
    m = ((yp & MASK30) * qinv) & MASK30
    u = (yp + m * p) >> 30          # ≡ x·R^{-1} (mod p), < 2^31
    for _ in range(3):
        u = jnp.where(u >= p, u - p, u)
    return mont_mul(u, r2, p, qinv)


# --------------------------------------------------------------------------
# Twiddle tables
# --------------------------------------------------------------------------

def _bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


@functools.lru_cache(maxsize=None)
def _host_tables(primes: tuple[int, ...], n: int):
    """Host-side twiddle tables (numpy int64, Montgomery form).

    Returns (psi_brv_mont, psi_inv_brv_mont, n_inv_mont):
      psi_brv_mont[P][j] = psi^{bitrev(j)}·R mod p for j in [0, N)
      (the classic Longa–Naehrig layout for merged negacyclic CT/GS NTTs).
    """
    from poulpy_tpu.hal.primes import R, psi_2n

    logn = n.bit_length() - 1
    P = len(primes)
    psi_t = np.zeros((P, n), dtype=np.int64)
    psi_inv_t = np.zeros((P, n), dtype=np.int64)
    n_inv = np.zeros((P,), dtype=np.int64)
    for k, p in enumerate(primes):
        psi = psi_2n(p, 2 * n)
        psi_inv = pow(psi, -1, p)
        for j in range(n):
            b = _bit_reverse(j, logn)
            psi_t[k, j] = pow(psi, b, p) * R % p
            psi_inv_t[k, j] = pow(psi_inv, b, p) * R % p
        n_inv[k] = pow(n, -1, p) * R % p
    return psi_t, psi_inv_t, n_inv


class NttTables:
    """Device twiddle tables for one (prime basis, N)."""

    def __init__(self, basis: PrimeBasis, n: int):
        assert n & (n - 1) == 0 and n >= 4, "N must be a power of two >= 4"
        self.basis = basis
        self.n = n
        self.logn = n.bit_length() - 1
        psi, psi_inv, n_inv = _host_tables(basis.primes, n)
        self.psi_brv = jnp.asarray(psi)            # [P, N] Montgomery
        self.psi_inv_brv = jnp.asarray(psi_inv)    # [P, N] Montgomery
        self.n_inv = jnp.asarray(n_inv)            # [P]    Montgomery
        self.p = jnp.asarray(basis.p_arr)          # [P]
        self.qinv = jnp.asarray(basis.qinv_arr)    # [P]
        self.r2 = jnp.asarray(basis.r2_arr)        # [P]
        self.two32_mod_p = jnp.asarray(basis.two32_mod_p_arr)
        self.two40_mod_p = jnp.asarray(basis.two40_mod_p_arr)
        # Garner lift constants
        self.garner_inv = jnp.asarray(basis.garner_inv)            # [P]
        self.garner_pprod = jnp.asarray(basis.garner_pprod_mod)    # [P, P]
        self.garner_inv_mont = jnp.asarray(basis.garner_inv_mont)
        self.garner_pprod_mont = jnp.asarray(basis.garner_pprod_mont)
        self.garner_weight = jnp.asarray(basis.garner_weight_u64)  # [P]
        self.modulus_u64 = jnp.asarray(basis.modulus_u64)          # scalar
        self.half_digits = jnp.asarray(basis.half_digits)          # [P]


# --------------------------------------------------------------------------
# Forward / inverse negacyclic NTT
# --------------------------------------------------------------------------

def ntt_forward(t: NttTables, x):
    """Negacyclic forward NTT, per prime.

    x: `[..., P, N]` standard-form residues → `[..., P, N]` (bit-reversed
    frequency order — internal convention; only pointwise ops happen in this
    domain, and `ntt_inverse` undoes it).

    Cooley–Tukey with merged psi powers: stage m has m butterflies blocks of
    half-length t = N/(2m); w for block i is psi^{brv(m+i)}.
    """
    n = t.n
    p = t.p[:, None]          # [P, 1]
    qinv = t.qinv[:, None]
    lead = x.shape[:-2]
    P = x.shape[-2]
    for s in range(t.logn):
        m = 1 << s
        half = n >> (s + 1)
        w = t.psi_brv[:, m : 2 * m]            # [P, m] Montgomery
        xr = x.reshape(lead + (P, m, 2, half))
        lo = xr[..., 0, :]
        hi = xr[..., 1, :]
        v = mont_mul(hi, w[..., :, None], p[..., None], qinv[..., None])
        nlo = add_mod(lo, v, p[..., None])
        nhi = sub_mod(lo, v, p[..., None])
        x = jnp.stack([nlo, nhi], axis=-2).reshape(lead + (P, n))
    return x


def ntt_inverse(t: NttTables, x):
    """Inverse of `ntt_forward` (Gentleman–Sande, then scale by N^{-1})."""
    n = t.n
    p = t.p[:, None]
    qinv = t.qinv[:, None]
    lead = x.shape[:-2]
    P = x.shape[-2]
    for s in range(t.logn - 1, -1, -1):
        m = 1 << s
        half = n >> (s + 1)
        w = t.psi_inv_brv[:, m : 2 * m]        # [P, m] Montgomery
        xr = x.reshape(lead + (P, m, 2, half))
        lo = xr[..., 0, :]
        hi = xr[..., 1, :]
        u = add_mod(lo, hi, p[..., None])
        d = sub_mod(lo, hi, p[..., None])
        v = mont_mul(d, w[..., :, None], p[..., None], qinv[..., None])
        x = jnp.stack([u, v], axis=-2).reshape(lead + (P, n))
    return mont_mul(x, t.n_inv[:, None], p, qinv)


# --------------------------------------------------------------------------
# Basis entry / exit
# --------------------------------------------------------------------------

def to_residues(t: NttTables, x):
    """int64 `[..., N]` → standard residues `[..., P, N]` (int32 at rest —
    the DFT-domain storage dtype, halving HBM traffic)."""
    return reduce_i64(
        x[..., None, :], t.p[:, None], t.qinv[:, None], t.r2[:, None],
        t.two40_mod_p[:, None],
    ).astype(jnp.int32)


def to_mont(t: NttTables, r):
    """Standard residues → Montgomery form (for prepared operands)."""
    return mont_mul(r, t.r2[:, None], t.p[:, None], t.qinv[:, None])


def garner_lift(t: NttTables, r):
    """Centered CRT lift: residues `[..., P, N]` → wrapping int64 `[..., N]`.

    Garner's mixed-radix algorithm (the exact-integer equivalent of the
    reference NTT120 backend's i128 reconstruction,
    poulpy-cpu-ref/src/reference/ntt120/mod.rs:34-44): digits d_i in [0, p_i),
    value V = Σ d_i·W_i computed mod 2^64, centered by subtracting M when the
    mixed-radix digit vector exceeds floor(M/2).  Exact whenever the true
    value's magnitude is < M/2 (guaranteed by Module parameter validation).
    """
    r = r.astype(I64)
    P = r.shape[-2]
    p = t.p
    digits = []
    for i in range(P):
        x = r[..., i, :]
        for j in range(i):
            # division-free: constants pre-multiplied by R, one REDC each
            x = sub_mod(
                x, mont_mul(digits[j], t.garner_pprod_mont[i, j], p[i], t.qinv[i]), p[i]
            )
        if i > 0:
            x = mont_mul(x, t.garner_inv_mont[i], p[i], t.qinv[i])
        digits.append(x)
    # V mod 2^64 (wrapping int64 multiply-accumulate)
    v = jnp.zeros_like(r[..., 0, :])
    for i in range(P):
        v = v + digits[i] * t.garner_weight[i]
    # lexicographic compare of (d_{P-1}, …, d_0) with digits of floor(M/2)
    gt = jnp.zeros(v.shape, dtype=bool)
    eq = jnp.ones(v.shape, dtype=bool)
    for i in range(P - 1, -1, -1):
        gt = gt | (eq & (digits[i] > t.half_digits[i]))
        eq = eq & (digits[i] == t.half_digits[i])
    return v - jnp.where(gt, t.modulus_u64, jnp.int64(0))
