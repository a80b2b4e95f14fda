"""NTT-friendly prime basis generation and host-side CRT constants.

The reference implements two exact-or-deterministic DFT families: a f64
negacyclic FFT (FFT64, poulpy-cpu-ref/src/reference/fft64/) and a CRT-NTT
over four ~30-bit primes (NTT120, poulpy-cpu-ref/src/reference/ntt120/primes.rs).
This library uses a single exact CRT-NTT basis as its only DFT domain, so
device results are exact integers independent of summation order: `nprimes`
primes `p ≡ 1 (mod 2·N_max)`, each `p < 2^30` so that Montgomery
multiplication with R = 2^30 stays inside signed-int64 intermediate range
(t + m·p < 2^60 + 2^60 < 2^63).

Because outputs are only compared at the *normalized limb* boundary
(poulpy-hal/src/test_suite/vmp.rs:21-110 compares normalized outputs across
backends), the concrete primes are free parameters: any basis whose product
exceeds the exact convolution range reproduces the reference bit-exactly.

All constants here are computed host-side with Python big ints once per
(nprimes) choice and shipped to the device as int64 arrays.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

# Support ring degrees up to 2^16 (reference benches sweep log_n 10..16,
# poulpy-bench/src/params.rs:52-58) => primes must be 1 mod 2^17.
LOG_N_MAX = 16
PSI_ORDER = 1 << (LOG_N_MAX + 1)

# Montgomery radix R = 2^30: every intermediate of a REDC stays in signed
# int64 (t + m·p < 2^60 + 2^60 < 2^63).
R_BITS = 30
R = 1 << R_BITS
MASK30 = R - 1
MASK32 = (1 << 32) - 1


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(count: int, below: int = 1 << 30) -> tuple[int, ...]:
    """Largest `count` primes p < below with p ≡ 1 (mod 2^(LOG_N_MAX+1))."""
    primes = []
    c = (below - 1) // PSI_ORDER
    while len(primes) < count and c > 0:
        p = c * PSI_ORDER + 1
        if _is_prime(p):
            primes.append(p)
        c -= 1
    if len(primes) < count:
        raise ValueError(f"not enough NTT primes below {below}")
    return tuple(primes)


def _find_primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)^*."""
    factors = []
    phi = p - 1
    n = phi
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    g = 2
    while True:
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
        g += 1


@functools.lru_cache(maxsize=None)
def psi_2n(p: int, two_n: int) -> int:
    """A primitive (2N)-th root of unity mod p (fixed deterministically)."""
    assert (p - 1) % two_n == 0
    g = _find_primitive_root(p)
    return pow(g, (p - 1) // two_n, p)


@dataclass(frozen=True)
class PrimeBasis:
    """Host-side CRT constants for a fixed prime set.

    Device-array twiddle tables live in `hal.ntt.NttTables`; this class keeps
    only scalar/1-D per-prime constants (all int64-safe).
    """

    primes: tuple[int, ...]

    @property
    def nprimes(self) -> int:
        return len(self.primes)

    @property
    def modulus(self) -> int:
        m = 1
        for p in self.primes:
            m *= p
        return m

    @functools.cached_property
    def p_arr(self) -> np.ndarray:  # [P]
        return np.array(self.primes, dtype=np.int64)

    @functools.cached_property
    def qinv_arr(self) -> np.ndarray:
        """-p^{-1} mod 2^32 per prime (Montgomery REDC constant)."""
        return np.array(
            [(-pow(p, -1, R)) % R for p in self.primes], dtype=np.int64
        )

    @functools.cached_property
    def r2_arr(self) -> np.ndarray:
        """R^2 mod p per prime (to enter Montgomery domain)."""
        return np.array([R * R % p for p in self.primes], dtype=np.int64)

    @functools.cached_property
    def r_mod_p_arr(self) -> np.ndarray:
        """R mod p per prime (Montgomery representation of 1)."""
        return np.array([R % p for p in self.primes], dtype=np.int64)

    @functools.cached_property
    def two32_mod_p_arr(self) -> np.ndarray:
        """2^32 mod p (for folding i64 values into the basis)."""
        return np.array([(1 << 32) % p for p in self.primes], dtype=np.int64)

    @functools.cached_property
    def two40_mod_p_arr(self) -> np.ndarray:
        """2^40 mod p (first-stage fold of full-range i64 inputs)."""
        return np.array([(1 << 40) % p for p in self.primes], dtype=np.int64)

    # --- Garner / mixed-radix CRT lift constants ------------------------

    @functools.cached_property
    def garner_inv(self) -> np.ndarray:
        """garner_inv[i] = (p_0·…·p_{i-1})^{-1} mod p_i  (index 0 unused)."""
        out = np.zeros(self.nprimes, dtype=np.int64)
        prod = 1
        for i, p in enumerate(self.primes):
            if i > 0:
                out[i] = pow(prod % p, -1, p)
            prod *= p
        return out

    @functools.cached_property
    def garner_pprod_mod(self) -> np.ndarray:
        """garner_pprod_mod[i][j] = (p_0·…·p_{j-1}) mod p_i, for j ≤ i."""
        P = self.nprimes
        out = np.zeros((P, P), dtype=np.int64)
        for i, p in enumerate(self.primes):
            prod = 1
            for j in range(P):
                out[i][j] = prod % p
                prod *= self.primes[j]
        return out

    @functools.cached_property
    def garner_pprod_mont(self) -> np.ndarray:
        """Montgomery form of garner_pprod_mod (division-free Garner)."""
        P = self.nprimes
        out = np.zeros((P, P), dtype=np.int64)
        for i, p in enumerate(self.primes):
            for j in range(P):
                out[i][j] = int(self.garner_pprod_mod[i][j]) * R % p
        return out

    @functools.cached_property
    def garner_inv_mont(self) -> np.ndarray:
        out = np.zeros(self.nprimes, dtype=np.int64)
        for i, p in enumerate(self.primes):
            if i > 0:
                out[i] = int(self.garner_inv[i]) * R % p
        return out

    @functools.cached_property
    def garner_weight_u64(self) -> np.ndarray:
        """W_i = (p_0·…·p_{i-1}) mod 2^64, as wrapping int64."""
        out = np.zeros(self.nprimes, dtype=np.uint64)
        prod = 1
        for i in range(self.nprimes):
            out[i] = prod % (1 << 64)
            prod *= self.primes[i]
        return out.view(np.int64)

    @functools.cached_property
    def modulus_u64(self) -> np.int64:
        """M mod 2^64 as wrapping int64 (for centering subtraction)."""
        return np.uint64(self.modulus % (1 << 64)).view(np.int64)

    @functools.cached_property
    def half_digits(self) -> np.ndarray:
        """Mixed-radix digits of floor(M/2) in basis (p_0, p_1, …)."""
        h = self.modulus // 2
        out = np.zeros(self.nprimes, dtype=np.int64)
        for i, p in enumerate(self.primes):
            out[i] = h % p
            h //= p
        return out

    def max_abs_value(self) -> int:
        """Largest |x| whose centered CRT image is unambiguous: (M-1)//2."""
        return (self.modulus - 1) // 2


def required_nprimes(base2k: int, log_n: int, log_rows: int = 7) -> int:
    """Number of ~30-bit primes needed for exact VMP/convolution accumulation.

    Bound on one output coefficient of a negacyclic product of normalized-limb
    polynomials accumulated over `2^log_rows` (rows × cols) terms:
        N · 2^(base2k-1)·2^(base2k-1) · 2^log_rows  =  2^(2·base2k - 2 + log_n + log_rows)
    The basis must satisfy 2·bound < M.
    """
    need_bits = 2 * base2k - 2 + log_n + log_rows + 2
    count = 1
    while True:
        basis = PrimeBasis(ntt_primes(count))
        if basis.modulus > (1 << need_bits):
            return count
        count += 1
