// Single-thread host-CPU BLOCK-BINARY BLIND ROTATION benchmark — the
// measured gate-bootstrap `vs_baseline` denominator for bench_full.py
//
// Faithful, performance-tuned C++ twin of the reference's FFT64/AVX
// block-binary CGGI loop (execute_block_binary,
// poulpy-bin-fhe/src/blind_rotation/algorithms/cggi/algorithm.rs:275-368)
// at the repo's gate-bootstrap configuration (binfhe/gates.py GateParams):
//   N=1024, base2k=17, acc k=34 (2 limbs), BRK k=68 (psize 4, dnum 4),
//   rank 1 (ci=co=2), n_lwe=568, block_size=8  ->  71 block steps/gate.
//
// Per block step:
//   fwd FFT the 4 acc rows; per block element i (8): rotate the 4 input
//   DFTs by the precomputed DFT(X^{a_i}-1) (the product is linear in acc,
//   so the rotate lands on the 4 input rows, not the 8 outputs),
//   VMP-accumulate the 8
//   output limb arrays; 8 inverse FFTs; += acc; carry-normalize.
//
// The FFT is the same four-step AVX-class formulation as
// baseline_bench.cpp, at M = 512 = 32 x 16 (every inner loop contiguous
// doubles).  Correctness gate before timing: one full block step must
// match an exact __int128 negacyclic-convolution oracle bit-for-bit.
//
// NOT included: mod-switch, sample extract, and the GLWE->LWE keyswitch a
// full gate pays (all cheap relative to 71 block steps) — omitting them
// makes this denominator FASTER than a real CPU gate, i.e. conservative
// against the accelerator's multiple.
//
// Build & run:
//   g++ -O3 -march=native -funroll-loops -o /tmp/baseline_gate_bench \
//       poulpy_tpu/native/baseline_gate_bench.cpp -lm
//   /tmp/baseline_gate_bench [seconds]

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

static const int N = 1024;
static const int M = N / 2;        // 512 complex points
static const int R1 = 32;          // four-step: M = R1 x R2
static const int R2 = 16;

static const int BASE2K = 17;
static const int CI = 2;           // rank+1 accumulator columns
static const int CO = 2;
static const int SIZE_A = 2;       // acc limbs (k=34)
static const int PSIZE = 4;        // BRK limbs (k=68)
static const int RMAX = 2;         // gadget rows actually consumed (= SIZE_A)
static const int BLOCK = 8;
static const int NBLOCKS = 71;     // n_lwe = 568

// ---------------------------------------------------------------------------
// Tables (stage tree shared by the 32- and 16-point column FFTs)
// ---------------------------------------------------------------------------

static double wtab_re[R1], wtab_im[R1];            // index h+i, ang = pi*i/h
static double bigtw_re[R1 * R2], bigtw_im[R1 * R2];  // W_M^{bitrev5(k)*b}
static double twist_re[M], twist_im[M];            // zeta^j, zeta=e^{i*pi/N}

static inline int bitrev5(int x) {
    int r = 0;
    for (int i = 0; i < 5; ++i) r |= ((x >> i) & 1) << (4 - i);
    return r;
}

static void build_tables() {
    for (int h = 1; h < R1; h <<= 1)
        for (int i = 0; i < h; ++i) {
            double ang = M_PI * (double)i / (double)h;
            wtab_re[h + i] = cos(ang);
            wtab_im[h + i] = sin(ang);
        }
    for (int k = 0; k < R1; ++k)
        for (int b = 0; b < R2; ++b) {
            double ang = 2.0 * M_PI * (double)(bitrev5(k) * b) / (double)M;
            bigtw_re[k * R2 + b] = cos(ang);
            bigtw_im[k * R2 + b] = sin(ang);
        }
    for (int j = 0; j < M; ++j) {
        double ang = M_PI * (double)j / (double)N;
        twist_re[j] = cos(ang);
        twist_im[j] = sin(ang);
    }
}

// P-point DIF column FFTs over a [P][C] row-major block (C columns).
template <int P, int C>
static void colfft_dif(double* __restrict re, double* __restrict im) {
    for (int h = P >> 1; h >= 1; h >>= 1) {
        for (int base = 0; base < P; base += 2 * h) {
            for (int i = 0; i < h; ++i) {
                double wr = wtab_re[h + i], wi = wtab_im[h + i];
                double* __restrict r0 = re + (base + i) * C;
                double* __restrict i0 = im + (base + i) * C;
                double* __restrict r1 = re + (base + i + h) * C;
                double* __restrict i1 = im + (base + i + h) * C;
                for (int c = 0; c < C; ++c) {
                    double ur = r0[c], ui = i0[c];
                    double vr = r1[c], vi = i1[c];
                    double dr = ur - vr, di = ui - vi;
                    r0[c] = ur + vr;
                    i0[c] = ui + vi;
                    r1[c] = dr * wr - di * wi;
                    i1[c] = dr * wi + di * wr;
                }
            }
        }
    }
}

template <int P, int C>
static void colfft_dit_inv(double* __restrict re, double* __restrict im) {
    for (int h = 1; h < P; h <<= 1) {
        for (int base = 0; base < P; base += 2 * h) {
            for (int i = 0; i < h; ++i) {
                double wr = wtab_re[h + i], wi = wtab_im[h + i];
                double* __restrict r0 = re + (base + i) * C;
                double* __restrict i0 = im + (base + i) * C;
                double* __restrict r1 = re + (base + i + h) * C;
                double* __restrict i1 = im + (base + i + h) * C;
                for (int c = 0; c < C; ++c) {
                    double vr = r1[c] * wr + i1[c] * wi;   // conj twiddle
                    double vi = i1[c] * wr - r1[c] * wi;
                    double ur = r0[c], ui = i0[c];
                    r0[c] = ur + vr;
                    i0[c] = ui + vi;
                    r1[c] = ur - vr;
                    i1[c] = ui - vi;
                }
            }
        }
    }
}

// [R1][R2] -> [R2][R1] out-of-place rectangular transpose.
static void transpose_fwd(const double* __restrict x, double* __restrict y) {
    for (int a = 0; a < R1; ++a)
        for (int b = 0; b < R2; ++b) y[b * R1 + a] = x[a * R2 + b];
}

static void transpose_bwd(const double* __restrict x, double* __restrict y) {
    for (int b = 0; b < R2; ++b)
        for (int a = 0; a < R1; ++a) y[a * R2 + b] = x[b * R1 + a];
}

static double scr_re[M], scr_im[M];

// forward m-point transform (permuted output order; VMP is pointwise)
static void fft_dif(double* __restrict re, double* __restrict im) {
    colfft_dif<R1, R2>(re, im);
    for (int j = 0; j < M; ++j) {
        double r = re[j], i = im[j];
        re[j] = r * bigtw_re[j] - i * bigtw_im[j];
        im[j] = r * bigtw_im[j] + i * bigtw_re[j];
    }
    transpose_fwd(re, scr_re);
    transpose_fwd(im, scr_im);
    memcpy(re, scr_re, sizeof(scr_re));
    memcpy(im, scr_im, sizeof(scr_im));
    colfft_dif<R2, R1>(re, im);
}

static void fft_dit_inv(double* __restrict re, double* __restrict im) {
    colfft_dit_inv<R2, R1>(re, im);
    transpose_bwd(re, scr_re);
    transpose_bwd(im, scr_im);
    memcpy(re, scr_re, sizeof(scr_re));
    memcpy(im, scr_im, sizeof(scr_im));
    for (int j = 0; j < M; ++j) {
        double r = re[j], i = im[j];
        re[j] = r * bigtw_re[j] + i * bigtw_im[j];   // conj
        im[j] = i * bigtw_re[j] - r * bigtw_im[j];
    }
    colfft_dit_inv<R1, R2>(re, im);
}

static void fwd_transform(const int64_t* __restrict x,
                          double* __restrict re, double* __restrict im) {
    for (int j = 0; j < M; ++j) {
        double lo = (double)x[j];
        double hi = (double)x[j + M];
        re[j] = lo * twist_re[j] - hi * twist_im[j];
        im[j] = lo * twist_im[j] + hi * twist_re[j];
    }
    fft_dif(re, im);
}

static void inv_transform(double* __restrict re, double* __restrict im,
                          int64_t* __restrict out) {
    fft_dit_inv(re, im);
    const double s = 1.0 / (double)M;
    for (int j = 0; j < M; ++j) {
        double r = (re[j] * twist_re[j] + im[j] * twist_im[j]) * s;
        double q = (im[j] * twist_re[j] - re[j] * twist_im[j]) * s;
        out[j] = llrint(r);
        out[j + M] = llrint(q);
    }
}

// ---------------------------------------------------------------------------
// Normalization
// ---------------------------------------------------------------------------

static inline int64_t get_digit(int64_t k, int64_t x) {
    int sh = (int)(64 - k);
    return (x << sh) >> sh;
}

static void big_normalize(const int64_t big[PSIZE][N],
                          int64_t res[SIZE_A][N]) {
    for (int c = 0; c < N; ++c) {
        int64_t carry = 0;
        int64_t digits[PSIZE];
        for (int j = PSIZE - 1; j >= 0; --j) {
            int64_t v = big[j][c] + carry;
            int64_t d = get_digit(BASE2K, v);
            carry = (v - d) >> BASE2K;
            digits[j] = d;
        }
        for (int j = 0; j < SIZE_A; ++j) res[j][c] = digits[j];
    }
}

// ---------------------------------------------------------------------------
// Keys and state
// ---------------------------------------------------------------------------

struct Prepared {  // BRK in DFT domain: [block][rows][ci][co][psize]
    double re[BLOCK][RMAX][CI][CO][PSIZE][M];
    double im[BLOCK][RMAX][CI][CO][PSIZE][M];
};

static int64_t ACC[CI][SIZE_A][N];
static int64_t PM[BLOCK][RMAX][CI][CO][PSIZE][N];
static Prepared* PREP;

// DFT(X^a - 1) for every a in [0, 2N): 16 MB, built once (the x_pow_a
// cache, blind_rotation/layouts/key.rs + utils.rs:6)
static double (*xpow_re)[M];
static double (*xpow_im)[M];

static void build_xpow() {
    xpow_re = new double[2 * N][M];
    xpow_im = new double[2 * N][M];
    static int64_t mono[N];
    for (int a = 0; a < 2 * N; ++a) {
        memset(mono, 0, sizeof(mono));
        if (a < N) mono[a] += 1;
        else       mono[a - N] -= 1;    // X^{N+j} = -X^j
        mono[0] -= 1;                   // the "- 1" folded into the table
        fwd_transform(mono, xpow_re[a], xpow_im[a]);
    }
}

static double adft_re[CI][SIZE_A][M], adft_im[CI][SIZE_A][M];
static double rot_re[CI][SIZE_A][M], rot_im[CI][SIZE_A][M];
static double add_re[CO][PSIZE][M], add_im[CO][PSIZE][M];
static int64_t big[PSIZE][N];

// One block-binary block step: ACC <- normalize(ACC + sum_i
// (X^{a_i}-1) * (ACC (gadget-x) BRK_i)), rotate applied input-side.
static void block_step(const int* a_vals) {
    for (int i = 0; i < CI; ++i)
        for (int r = 0; r < SIZE_A; ++r)
            fwd_transform(ACC[i][r], adft_re[i][r], adft_im[i][r]);
    memset(add_re, 0, sizeof(add_re));
    memset(add_im, 0, sizeof(add_im));
    for (int e = 0; e < BLOCK; ++e) {
        const double* __restrict xr = xpow_re[a_vals[e] & (2 * N - 1)];
        const double* __restrict xi = xpow_im[a_vals[e] & (2 * N - 1)];
        // rotate the 4 input rows once per element
        for (int i = 0; i < CI; ++i)
            for (int r = 0; r < RMAX; ++r) {
                const double* __restrict ar = adft_re[i][r];
                const double* __restrict ai = adft_im[i][r];
                double* __restrict orr = rot_re[i][r];
                double* __restrict oi = rot_im[i][r];
                for (int j = 0; j < M; ++j) {
                    orr[j] = ar[j] * xr[j] - ai[j] * xi[j];
                    oi[j] = ar[j] * xi[j] + ai[j] * xr[j];
                }
            }
        for (int co = 0; co < CO; ++co)
            for (int l = 0; l < PSIZE; ++l) {
                double* __restrict accr = add_re[co][l];
                double* __restrict acci = add_im[co][l];
                for (int r = 0; r < RMAX; ++r)
                    for (int i = 0; i < CI; ++i) {
                        const double* __restrict ar = rot_re[i][r];
                        const double* __restrict ai = rot_im[i][r];
                        const double* __restrict pr = PREP->re[e][r][i][co][l];
                        const double* __restrict pi = PREP->im[e][r][i][co][l];
                        for (int j = 0; j < M; ++j) {
                            accr[j] += ar[j] * pr[j] - ai[j] * pi[j];
                            acci[j] += ar[j] * pi[j] + ai[j] * pr[j];
                        }
                    }
            }
    }
    for (int co = 0; co < CO; ++co) {
        for (int l = 0; l < PSIZE; ++l)
            inv_transform(add_re[co][l], add_im[co][l], big[l]);
        for (int l = 0; l < SIZE_A; ++l)
            for (int c = 0; c < N; ++c) big[l][c] += ACC[co][l][c];
        big_normalize(big, ACC[co]);
    }
}

// ---------------------------------------------------------------------------
// Exact oracle for one block step (__int128 negacyclic convolutions)
// ---------------------------------------------------------------------------

static void oracle_block_step(const int64_t acc_in[CI][SIZE_A][N],
                              const int* a_vals,
                              int64_t acc_out[CI][SIZE_A][N]) {
    static __int128 conv[N];
    static int64_t bigx[PSIZE][N];
    for (int co = 0; co < CO; ++co) {
        for (int l = 0; l < PSIZE; ++l) {
            memset(conv, 0, sizeof(conv));
            for (int e = 0; e < BLOCK; ++e) {
                int a = a_vals[e] & (2 * N - 1);
                for (int r = 0; r < RMAX; ++r)
                    for (int i = 0; i < CI; ++i)
                        for (int x = 0; x < N; ++x) {
                            int64_t av = acc_in[i][r][x];
                            if (!av) continue;
                            const int64_t* pv = PM[e][r][i][co][l];
                            for (int y = 0; y < N; ++y) {
                                __int128 p = (__int128)av * pv[y];
                                // times (X^a - 1): add at x+y+a, sub at x+y
                                int k1 = x + y + a;
                                int s1 = 1;
                                while (k1 >= N) { k1 -= N; s1 = -s1; }
                                if (s1 > 0) conv[k1] += p; else conv[k1] -= p;
                                int k0 = x + y;
                                int s0 = 1;
                                if (k0 >= N) { k0 -= N; s0 = -1; }
                                if (s0 > 0) conv[k0] -= p; else conv[k0] += p;
                            }
                        }
            }
            for (int x = 0; x < N; ++x) bigx[l][x] = (int64_t)conv[x];
        }
        for (int l = 0; l < SIZE_A; ++l)
            for (int c = 0; c < N; ++c) bigx[l][c] += acc_in[co][l][c];
        big_normalize(bigx, acc_out[co]);
    }
}

// ---------------------------------------------------------------------------

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static uint64_t rnd_u64() {
    uint64_t z = (rng_state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}
static int64_t rnd_limb() {
    return (int64_t)(rnd_u64() % 131072) - 65536;  // [-2^16, 2^16)
}

int main(int argc, char** argv) {
    double budget_s = argc > 1 ? atof(argv[1]) : 3.0;
    build_tables();
    build_xpow();
    PREP = new Prepared;
    for (int i = 0; i < CI; ++i)
        for (int r = 0; r < SIZE_A; ++r)
            for (int x = 0; x < N; ++x) ACC[i][r][x] = rnd_limb();
    for (int e = 0; e < BLOCK; ++e)
        for (int r = 0; r < RMAX; ++r)
            for (int i = 0; i < CI; ++i)
                for (int co = 0; co < CO; ++co)
                    for (int l = 0; l < PSIZE; ++l) {
                        for (int x = 0; x < N; ++x)
                            PM[e][r][i][co][l][x] = rnd_limb();
                        fwd_transform(PM[e][r][i][co][l],
                                      PREP->re[e][r][i][co][l],
                                      PREP->im[e][r][i][co][l]);
                    }

    // correctness gate: one FFT block step == exact __int128 oracle
    static int a_vals[BLOCK];
    for (int e = 0; e < BLOCK; ++e) a_vals[e] = (int)(rnd_u64() % (2 * N));
    static int64_t acc_in[CI][SIZE_A][N], want[CI][SIZE_A][N];
    memcpy(acc_in, ACC, sizeof(ACC));
    oracle_block_step(acc_in, a_vals, want);
    block_step(a_vals);
    for (int i = 0; i < CI; ++i)
        for (int l = 0; l < SIZE_A; ++l)
            for (int x = 0; x < N; ++x)
                if (ACC[i][l][x] != want[i][l][x]) {
                    fprintf(stderr,
                            "MISMATCH col=%d l=%d x=%d have=%lld want=%lld\n",
                            i, l, x, (long long)ACC[i][l][x],
                            (long long)want[i][l][x]);
                    return 1;
                }

    // timed region: NBLOCKS block steps = one blind rotation (gate's BR)
    using clk = std::chrono::steady_clock;
    long iters = 8;
    for (;;) {
        auto t0 = clk::now();
        for (long it = 0; it < iters; ++it)
            for (int blk = 0; blk < NBLOCKS; ++blk) {
                for (int e = 0; e < BLOCK; ++e)
                    a_vals[e] = (int)((blk * BLOCK + e * 97 + it) % (2 * N));
                block_step(a_vals);
            }
        double dt = std::chrono::duration<double>(clk::now() - t0).count();
        if (dt >= budget_s || iters > (1L << 28)) {
            printf("{\"metric\": \"cpu_fft64_block_binary_bootstraps_per_s_"
                   "1thread\", \"value\": %.1f, \"unit\": \"bootstraps/s\", "
                   "\"iters\": %ld, \"seconds\": %.3f}\n",
                   iters / dt, iters, dt);
            break;
        }
        iters = (long)(iters * (budget_s * 1.2 / dt)) + 1;
    }
    delete PREP;
    delete[] xpow_re;
    delete[] xpow_im;
    return 0;
}
