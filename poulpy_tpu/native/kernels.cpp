// Native host-side kernel library for poulpy_tpu.
//
// The reference implements its host kernels in native code
// (poulpy-cpu-ref/src/reference/: znx scalar kernels, normalization carry
// chains, sampling, ChaCha8 source; ~18 kLoC Rust).  This library keeps
// device compute in XLA, but the host-side runtime around it —
// deterministic key/noise generation, golden-oracle arithmetic for the test
// suite, and coefficient-domain utility kernels — is native here too:
// this C++ library is the poulpy-cpu-ref twin, exposed to Python through
// ctypes (poulpy_tpu/native/__init__.py) and cross-checked bit-exactly
// against the jnp/numpy implementations by tests/test_native.py.
//
// Everything is exact integer arithmetic: wrapping int64 limbs (like the
// reference's VecZnx), __int128 accumulation for the convolution oracle
// (the NTT120 ScalarBig analogue, reference/ntt120/mod.rs:34-44).
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py; no external deps).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// ChaCha8 keystream (poulpy-hal/src/source.rs:18-97 twin; layout matches
// rand_chacha / hal/source.py: constants | key | 64-bit counter | stream 0,
// 8 rounds, output = post-round state + input state).
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

#define QR(a, b, c, d)                                                      \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16);                           \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12);                           \
    x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);                            \
    x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7);

// key: 8 u32 words; out: nblocks × 16 u32 words for counters
// counter0 .. counter0+nblocks-1 (stream id fixed 0).
void chacha8_blocks(const uint32_t* key, uint64_t counter0,
                    uint64_t nblocks, uint32_t* out) {
    for (uint64_t blk = 0; blk < nblocks; ++blk) {
        uint64_t ctr = counter0 + blk;
        uint32_t st[16];
        st[0] = 0x61707865u; st[1] = 0x3320646Eu;
        st[2] = 0x79622D32u; st[3] = 0x6B206574u;
        for (int i = 0; i < 8; ++i) st[4 + i] = key[i];
        st[12] = (uint32_t)(ctr & 0xFFFFFFFFu);
        st[13] = (uint32_t)(ctr >> 32);
        st[14] = 0; st[15] = 0;
        uint32_t x[16];
        std::memcpy(x, st, sizeof(st));
        for (int r = 0; r < 4; ++r) {   // 8 rounds = 4 double-rounds
            QR(0, 4, 8, 12) QR(1, 5, 9, 13) QR(2, 6, 10, 14) QR(3, 7, 11, 15)
            QR(0, 5, 10, 15) QR(1, 6, 11, 12) QR(2, 7, 8, 13) QR(3, 4, 9, 14)
        }
        uint32_t* o = out + 16 * blk;
        for (int i = 0; i < 16; ++i) o[i] = x[i] + st[i];
    }
}

// ---------------------------------------------------------------------------
// znx coefficient kernels (reference/znx/{rotate,automorphism}.rs twins),
// wrapping int64, rows × n row-major.
// ---------------------------------------------------------------------------

// res = a · X^p in Z[X]/(X^N+1): res[i] = ±a[(i−p) mod N]
void znx_rotate_i64(int64_t p, const int64_t* a, int64_t* out,
                    int64_t rows, int64_t n) {
    int64_t mask2n = 2 * n - 1;
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t* ar = a + r * n;
        int64_t* orow = out + r * n;
        for (int64_t i = 0; i < n; ++i) {
            int64_t q = (i - p) & mask2n;
            orow[i] = (q < n) ? ar[q] : -ar[q - n];
        }
    }
}

// res(X) = a(X^p): scatter a[i] → ±res[(i·p) mod 2N]
// (znx_automorphism_ref, reference/znx/automorphism.rs:1-17)
void znx_automorphism_i64(int64_t p, const int64_t* a, int64_t* out,
                          int64_t rows, int64_t n) {
    int64_t mask2n = 2 * n - 1;
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t* ar = a + r * n;
        int64_t* orow = out + r * n;
        orow[0] = ar[0];
        int64_t k = 0;
        for (int64_t i = 1; i < n; ++i) {
            k = (k + p) & mask2n;
            if (k < n) orow[k] = ar[i];
            else       orow[k - n] = -ar[i];
        }
    }
}

// ---------------------------------------------------------------------------
// Base-2^k carry-propagation normalization
// (reference/znx/normalization.rs first/middle/final schedule, identical to
// hal/normalization.py vec_znx_normalize): x is [size, n] limb-major,
// normalized in place with optional fused lsh.
// ---------------------------------------------------------------------------

static inline int64_t get_digit(int64_t k, int64_t x) {
    int sh = (int)(64 - k);
    return (x << sh) >> sh;
}

static inline int64_t get_carry(int64_t k, int64_t x, int64_t digit) {
    return (x - digit) >> k;
}

void vec_znx_normalize_i64(int64_t base2k, int64_t lsh, int64_t* x,
                           int64_t size, int64_t n) {
    int64_t k = base2k - lsh;
    if (size == 1) {
        for (int64_t c = 0; c < n; ++c)
            x[c] = get_digit(base2k, get_digit(k, x[c]) << lsh);
        return;
    }
    for (int64_t c = 0; c < n; ++c) {
        // first (lowest) limb
        int64_t* last = x + (size - 1) * n;
        int64_t d = get_digit(k, last[c]);
        int64_t carry = get_carry(k, last[c], d);
        last[c] = d << lsh;
        // middle limbs
        for (int64_t j = size - 2; j > 0; --j) {
            int64_t* row = x + j * n;
            int64_t dj = get_digit(k, row[c]);
            int64_t cj = get_carry(k, row[c], dj);
            int64_t dpc = (dj << lsh) + carry;
            int64_t x1 = get_digit(base2k, dpc);
            row[c] = x1;
            carry = cj + get_carry(base2k, dpc, x1);
        }
        // final (top) limb: outgoing carry dropped (mod 1 on the torus)
        x[c] = get_digit(base2k, (get_digit(k, x[c]) << lsh) + carry);
    }
}

// ---------------------------------------------------------------------------
// Exact negacyclic convolution with 128-bit accumulation — the golden-oracle
// kernel (replaces the Python big-int loop in tests/oracle.py when bounds
// allow; NTT120 i128 ScalarBig analogue).  out = a ⊛ b in Z[X]/(X^N+1),
// result returned as (hi, lo) signed-128 pairs (lo unsigned).
// Caller guarantees Σ |a_i·b_j| < 2^127 (checked host-side from the
// arrays' magnitudes).
// ---------------------------------------------------------------------------

void negacyclic_conv_i128(const int64_t* a, const int64_t* b,
                          int64_t* out_hi, uint64_t* out_lo, int64_t n) {
    __int128* acc = new __int128[n];
    for (int64_t i = 0; i < n; ++i) acc[i] = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t ai = a[i];
        if (ai == 0) continue;
        for (int64_t j = 0; j < n; ++j) {
            __int128 prod = (__int128)ai * (__int128)b[j];
            int64_t kidx = i + j;
            if (kidx < n) acc[kidx] += prod;
            else          acc[kidx - n] -= prod;
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        out_lo[i] = (uint64_t)(acc[i] & 0xFFFFFFFFFFFFFFFFu);
        out_hi[i] = (int64_t)(acc[i] >> 64);
    }
    delete[] acc;
}

// Batched variant: rows independent polynomials.
void negacyclic_conv_i128_batch(const int64_t* a, const int64_t* b,
                                int64_t* out_hi, uint64_t* out_lo,
                                int64_t rows, int64_t n) {
    for (int64_t r = 0; r < rows; ++r)
        negacyclic_conv_i128(a + r * n, b + r * n,
                             out_hi + r * n, out_lo + r * n, n);
}

// ---------------------------------------------------------------------------
// Negacyclic NTT per prime (Montgomery R = 2^30, same stage schedule and
// tables as hal/ntt.py — forward Cooley–Tukey with Montgomery twiddles,
// inverse Gentleman–Sande + N^{-1}).  x: [rows, n] int64 residues in [0, p).
// psi_t / psi_inv_t: the per-prime Montgomery twiddle tables of
// hal.ntt._host_tables ([n] int64).  Used for fast host-side golden vectors.
// ---------------------------------------------------------------------------

static inline int64_t mont_mul_p(int64_t a, int64_t b, int64_t p,
                                 int64_t qinv30) {
    const int64_t R_MASK = (1ll << 30) - 1;
    __int128 t = (__int128)a * b;
    int64_t t0 = (int64_t)(t & R_MASK);
    int64_t m = (t0 * qinv30) & R_MASK;
    __int128 u = (t + (__int128)m * p) >> 30;
    int64_t r = (int64_t)u;
    return r >= p ? r - p : r;
}

void ntt_forward_i64(const int64_t* psi_t, int64_t p, int64_t qinv,
                     int64_t* x, int64_t rows, int64_t n) {
    int logn = 0;
    while ((1ll << logn) < n) ++logn;
    for (int64_t r = 0; r < rows; ++r) {
        int64_t* xr = x + r * n;
        for (int s = 0; s < logn; ++s) {
            int64_t m = 1ll << s;
            int64_t half = n >> (s + 1);
            for (int64_t blk = 0; blk < m; ++blk) {
                int64_t w = psi_t[m + blk];
                int64_t* lo = xr + blk * 2 * half;
                int64_t* hi = lo + half;
                for (int64_t i = 0; i < half; ++i) {
                    int64_t v = mont_mul_p(hi[i], w, p, qinv);
                    int64_t u = lo[i];
                    int64_t s1 = u + v;  if (s1 >= p) s1 -= p;
                    int64_t s2 = u - v;  if (s2 < 0)  s2 += p;
                    lo[i] = s1;
                    hi[i] = s2;
                }
            }
        }
    }
}

void ntt_inverse_i64(const int64_t* psi_inv_t, int64_t ninv_mont, int64_t p,
                     int64_t qinv, int64_t* x, int64_t rows, int64_t n) {
    int logn = 0;
    while ((1ll << logn) < n) ++logn;
    for (int64_t r = 0; r < rows; ++r) {
        int64_t* xr = x + r * n;
        for (int s = logn - 1; s >= 0; --s) {
            int64_t m = 1ll << s;
            int64_t half = n >> (s + 1);
            for (int64_t blk = 0; blk < m; ++blk) {
                int64_t w = psi_inv_t[m + blk];
                int64_t* lo = xr + blk * 2 * half;
                int64_t* hi = lo + half;
                for (int64_t i = 0; i < half; ++i) {
                    int64_t u = lo[i], v = hi[i];
                    int64_t s1 = u + v;  if (s1 >= p) s1 -= p;
                    int64_t d = u - v;   if (d < 0)   d += p;  // lo − hi
                    lo[i] = s1;
                    hi[i] = mont_mul_p(d, w, p, qinv);
                }
            }
        }
        for (int64_t i = 0; i < n; ++i)
            xr[i] = mont_mul_p(xr[i], ninv_mont, p, qinv);
    }
}

}  // extern "C"
