"""Exact Python big-int oracles for the kernel layer.

The reference uses cross-backend equivalence plus arbitrary-precision
(dashu FBig) checks as its test oracles (SURVEY.md §4).  Without a Rust
toolchain in this image, the arbitrary-precision oracle is Python's native
big int: exact negacyclic convolution, exact limb re-composition, exact
windowed normalization.
"""

from __future__ import annotations

import numpy as np


def negacyclic_mul(a: list[int], b: list[int]) -> list[int]:
    """Exact product in Z[X]/(X^N+1).

    Fast path: the native C++ __int128 kernel (poulpy_tpu/native) when the
    result provably fits 128 bits; exact Python big ints otherwise."""
    n = len(a)
    try:
        from poulpy_tpu import native

        if native.available():
            return native.negacyclic_mul_exact(a, b)
    except (OverflowError, ImportError):
        pass
    out = [0] * n
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] += ai * bj
            else:
                out[k - n] -= ai * bj
    return out


def limbs_to_int(limbs: np.ndarray, base2k: int) -> list[int]:
    """Compose limb vector [size, N] into exact integers scaled by
    2^{size·base2k} (i.e. value·2^{size·base2k}, one big int per coeff)."""
    size, n = limbs.shape
    out = []
    for c in range(n):
        v = 0
        for j in range(size):
            v = (v << base2k) + int(limbs[j, c])
        out.append(v)
    return out


def int_to_balanced_limbs(vals: list[int], base2k: int, size: int) -> np.ndarray:
    """Exact balanced base-2^k digits of vals·2^{-size·base2k} mod 1.

    Mirrors the normalization contract: digits in [-2^{k-1}, 2^{k-1}),
    value preserved mod 2^{size·base2k} (torus wrap).
    """
    n = len(vals)
    out = np.zeros((size, n), dtype=np.int64)
    half = 1 << (base2k - 1)
    mod = 1 << (size * base2k)
    for c, v in enumerate(vals):
        v = v % mod
        if v >= mod // 2:
            v -= mod
        digits = []
        for _ in range(size):
            d = ((v + half) % (1 << base2k)) - half
            digits.append(d)
            v = (v - d) >> base2k
        for j in range(size):
            out[size - 1 - j, c] = digits[j]
    return out


def vec_value_mod1(limbs: np.ndarray, base2k: int) -> list:
    """Exact torus value·2^{size·base2k} as centered big ints."""
    vals = limbs_to_int(limbs, base2k)
    mod = 1 << (limbs.shape[0] * base2k)
    out = []
    for v in vals:
        v %= mod
        if v >= mod // 2:
            v -= mod
        out.append(v)
    return out


def normalize(vals, a_base2k: int, res_size: int, res_base2k: int,
              offset: int = 0) -> np.ndarray:
    """Exact model of the big-accumulator normalization
    (hal.normalization.vec_znx_normalize_full and its wide twin).

    `vals[j][c]` is limb j of coefficient c, an exact integer weighing
    2^{-(j+1)·a_base2k} on the torus.  Each limb's contribution is floored
    at the output precision, the sum is taken mod 1 and written as
    `[res_size, N]` balanced base-2^res_base2k digits (limb 0 most
    significant):
        total = Σ_j floor(v_j · 2^{res_size·kr − (j+1)·ka + offset}).
    """
    n = len(vals[0])
    totals = [0] * n
    for j, limb in enumerate(vals):
        t = res_size * res_base2k - (j + 1) * a_base2k + offset
        for c in range(n):
            v = int(limb[c])
            totals[c] += v << t if t >= 0 else v >> (-t)
    return int_to_balanced_limbs(totals, res_base2k, res_size)


def to_int64(v: int) -> int:
    """Two's-complement wrap of an exact integer to signed 64 bits (what a
    wrapping int64 accumulator holds)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def poly_add(a: list[int], b: list[int]) -> list[int]:
    return [x + y for x, y in zip(a, b)]


def vmp(a, mat, limb_offset: int = 0, res_size: int | None = None):
    """Exact vector-matrix product of hal.dft.vmp_apply, in big ints.

    `a` [cols_in, size_a, N] and `mat` [rows, cols_in, cols_out, psize, N]
    (integer arrays); returns res[co][j] (lists of ints) with
    res[co][j] = Σ_{ci, r < min(rows, size_a)} a[ci][r] ⊛ mat[r][ci][co][j +
    limb_offset] for j + limb_offset < psize, zero beyond, j < res_size."""
    rows, cols_in, cols_out, psize, n = np.shape(mat)
    res_size = psize if res_size is None else res_size
    rmax = min(rows, np.shape(a)[1])
    out = []
    for co in range(cols_out):
        col = []
        for j in range(res_size):
            acc = [0] * n
            if j + limb_offset < psize:
                for ci in range(cols_in):
                    for r in range(rmax):
                        acc = poly_add(acc, negacyclic_mul(
                            [int(v) for v in a[ci][r]],
                            [int(v) for v in mat[r][ci][co][j + limb_offset]],
                        ))
            col.append(acc)
        out.append(col)
    return out


def limb_conv(a, b, res_size: int):
    """Bivariate limb convolution of two limb vectors [size, N]:
    res[k] = Σ_{i+j=k} a[i] ⊛ b[j] (hal.dft.cnv_apply), exact."""
    n = np.shape(a)[-1]
    out = []
    for k in range(res_size):
        acc = [0] * n
        for i in range(np.shape(a)[0]):
            j = k - i
            if 0 <= j < np.shape(b)[0]:
                acc = poly_add(acc, negacyclic_mul(
                    [int(v) for v in a[i]], [int(v) for v in b[j]]))
        out.append(acc)
    return out


def align(limbs, size: int, n: int):
    """Zero-pad or truncate a limb list to `size` limbs."""
    limbs = [list(map(int, x)) for x in limbs[:size]]
    return limbs + [[0] * n for _ in range(size - len(limbs))]
