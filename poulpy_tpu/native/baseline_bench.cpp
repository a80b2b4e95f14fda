// Single-thread host-CPU external-product benchmark — the measured
// `vs_baseline` denominator for bench.py.
//
// This is a faithful, performance-tuned C++ twin of the reference's
// FFT64/AVX external product (the algorithm poulpy-cpu-avx implements in
// reim/reim4 AVX2+FMA kernels, poulpy-cpu-avx/src/fft64/reim4/
// arithmetic_avx.rs; pipeline per poulpy-core/src/external_product/
// glwe.rs:99-271):
//
//   per GLWE column (ci=2): i64 limbs -> f64 + negacyclic twist -> FFT(m)
//   VMP: res_dft[co][l] = sum_{r,i} a_dft[i][r] * pmat[r][i][co][l]
//   per output (co=2, psize=4): iFFT -> untwist -> round to i64 big
//   per col: base-2^k carry-propagation normalize to res_size limbs
//
// Negacyclic transform: m = N/2 complex points; c_j = (a_j + i*a_{j+m}) *
// zeta^j with zeta = exp(i*pi/N), then an m-point DFT with e^{+2pi i/m}
// kernel evaluates the real poly at the 2N-th roots zeta^{4k+1} (the other
// half are conjugates) — the same "reim" folding as the reference
// (poulpy-cpu-ref/src/reference/fft64/reim/fft_ref.rs:25-43).  DIF forward
// (natural -> bit-reversed) pairs with DIT inverse so no reordering is
// needed; VMP is pointwise so it runs in bit-reversed order.
//
// Configuration = bench.py's headline external product: N=2048, base2k=17,
// ct k=51 (3 limbs), GGSW k=68 (psize=4), dnum(rows)=3, rank 1 (ci=co=2).
//
// Correctness is asserted before timing against an exact __int128
// negacyclic-convolution oracle (f64 roundoff at these magnitudes is
// < 0.5 ulp of the integer result, so the rounded outputs must match
// EXACTLY — the reference's own determinism contract, README.md:44).
//
// Build & run:
//   g++ -O3 -march=native -funroll-loops -o /tmp/baseline_bench \
//       poulpy_tpu/native/baseline_bench.cpp -lm
//   /tmp/baseline_bench [seconds]

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

static const int N = 2048;
static const int M = N / 2;
static const int LOGM = 10;
static const int R = 32;   // four-step split: M = R x R

static const int BASE2K = 17;
static const int CI = 2;       // rank+1 input columns
static const int CO = 2;       // rank+1 output columns
static const int ROWS = 3;     // dnum
static const int SIZE_A = 3;   // ct limbs (k=51)
static const int PSIZE = 4;    // GGSW limbs (k=68)
static const int RES_SIZE = 3;

// ---------------------------------------------------------------------------
// Tables
// ---------------------------------------------------------------------------

// The m-point FFT runs as a FOUR-STEP decomposition (m = 32x32): 32-point
// DIF column FFTs operate on whole 32-double rows (unit stride, fully
// auto-vectorized), then a folded twiddle multiply, a 32x32 transpose, and
// a second bank of column FFTs.  The output lands in a fixed permutation
// pi of the DFT — irrelevant because VMP is pointwise and the inverse
// transform exactly mirrors the steps (conjugate tables, reverse order).
// This is the honest AVX-class formulation: every inner loop is 32
// contiguous doubles, matching what the reference achieves with
// hand-written reim asm kernels (poulpy-cpu-avx/src/fft64/reim/).

static double w32_re[R], w32_im[R];        // stage tree: index h+i
static double bigtw_re[R * R], bigtw_im[R * R];  // W_m^{bitrev5(k) * b}
static double twist_re[M], twist_im[M];    // zeta^j, zeta = exp(i*pi/N)

static inline int bitrev5(int x) {
    int r = 0;
    for (int i = 0; i < 5; ++i) r |= ((x >> i) & 1) << (4 - i);
    return r;
}

static void build_tables() {
    for (int h = 1; h < R; h <<= 1)
        for (int i = 0; i < h; ++i) {
            double ang = M_PI * (double)i / (double)h;  // e^{+i*pi*i/h}
            w32_re[h + i] = cos(ang);
            w32_im[h + i] = sin(ang);
        }
    for (int k = 0; k < R; ++k)
        for (int b = 0; b < R; ++b) {
            double ang = 2.0 * M_PI * (double)(bitrev5(k) * b) / (double)M;
            bigtw_re[k * R + b] = cos(ang);
            bigtw_im[k * R + b] = sin(ang);
        }
    for (int j = 0; j < M; ++j) {
        double ang = M_PI * (double)j / (double)N;
        twist_re[j] = cos(ang);
        twist_im[j] = sin(ang);
    }
}

// 32 parallel 32-point DIF column FFTs over a [32][32] row-major block,
// kernel e^{+2pi i/32}; output rows in bit-reversed order.
static void colfft32_dif(double* __restrict re, double* __restrict im) {
    for (int h = R >> 1; h >= 1; h >>= 1) {
        for (int base = 0; base < R; base += 2 * h) {
            for (int i = 0; i < h; ++i) {
                double wr = w32_re[h + i], wi = w32_im[h + i];
                double* __restrict r0 = re + (base + i) * R;
                double* __restrict i0 = im + (base + i) * R;
                double* __restrict r1 = re + (base + i + h) * R;
                double* __restrict i1 = im + (base + i + h) * R;
                for (int c = 0; c < R; ++c) {
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

// Inverse of colfft32_dif: DIT with conjugate twiddles, bitrev -> natural.
static void colfft32_dit_inv(double* __restrict re, double* __restrict im) {
    for (int h = 1; h < R; h <<= 1) {
        for (int base = 0; base < R; base += 2 * h) {
            for (int i = 0; i < h; ++i) {
                double wr = w32_re[h + i], wi = w32_im[h + i];
                double* __restrict r0 = re + (base + i) * R;
                double* __restrict i0 = im + (base + i) * R;
                double* __restrict r1 = re + (base + i + h) * R;
                double* __restrict i1 = im + (base + i + h) * R;
                for (int c = 0; c < R; ++c) {
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

static void transpose32(double* __restrict x) {
    for (int a = 0; a < R; ++a)
        for (int b = a + 1; b < R; ++b) {
            double t = x[a * R + b];
            x[a * R + b] = x[b * R + a];
            x[b * R + a] = t;
        }
}

// forward m-point transform (permuted output order pi)
static void fft_dif(double* __restrict re, double* __restrict im) {
    colfft32_dif(re, im);
    for (int j = 0; j < M; ++j) {           // folded twiddle (bitrev in table)
        double r = re[j], i = im[j];
        re[j] = r * bigtw_re[j] - i * bigtw_im[j];
        im[j] = r * bigtw_im[j] + i * bigtw_re[j];
    }
    transpose32(re);
    transpose32(im);
    colfft32_dif(re, im);
}

// inverse (unscaled): exact mirror with conjugated tables
static void fft_dit_inv(double* __restrict re, double* __restrict im) {
    colfft32_dit_inv(re, im);
    transpose32(re);
    transpose32(im);
    for (int j = 0; j < M; ++j) {
        double r = re[j], i = im[j];
        re[j] = r * bigtw_re[j] + i * bigtw_im[j];   // conj
        im[j] = i * bigtw_re[j] - r * bigtw_im[j];
    }
    colfft32_dit_inv(re, im);
}

// i64 limb -> twisted complex -> forward FFT (reim_from_znx + fft).
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

// inverse FFT -> untwist -> rounded i64 big coefficients (reim_to_znx).
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
// Normalization (carry propagation, same schedule as kernels.cpp twin)
// ---------------------------------------------------------------------------

static inline int64_t get_digit(int64_t k, int64_t x) {
    int sh = (int)(64 - k);
    return (x << sh) >> sh;
}

// big[PSIZE][N] at scale ka=BASE2K*PSIZE -> res[RES_SIZE][N] at kr.
static void big_normalize(const int64_t big[PSIZE][N],
                          int64_t res[RES_SIZE][N]) {
    for (int c = 0; c < N; ++c) {
        int64_t carry = 0;
        int64_t digits[PSIZE];
        for (int j = PSIZE - 1; j >= 0; --j) {
            int64_t v = big[j][c] + carry;
            int64_t d = get_digit(BASE2K, v);
            carry = (v - d) >> BASE2K;
            digits[j] = d;
        }
        for (int j = 0; j < RES_SIZE; ++j) res[j][c] = digits[j];
    }
}

// ---------------------------------------------------------------------------
// External product
// ---------------------------------------------------------------------------

struct Prepared {  // pmat in DFT domain (reference VmpPMat analogue)
    double re[ROWS][CI][CO][PSIZE][M];
    double im[ROWS][CI][CO][PSIZE][M];
};

static int64_t A[CI][SIZE_A][N];        // input ct limbs
static int64_t PM[ROWS][CI][CO][PSIZE][N];  // key limbs (coeff domain)
static Prepared* PREP;
static int64_t RES[CO][RES_SIZE][N];

static double adft_re[CI][SIZE_A][M], adft_im[CI][SIZE_A][M];
static double acc_re[M], acc_im[M];
static int64_t big[PSIZE][N];

static void external_product() {
    // forward: ci x size_a transforms
    for (int i = 0; i < CI; ++i)
        for (int r = 0; r < SIZE_A; ++r)
            fwd_transform(A[i][r], adft_re[i][r], adft_im[i][r]);
    // VMP + inverse per output (co, limb)
    for (int co = 0; co < CO; ++co) {
        for (int l = 0; l < PSIZE; ++l) {
            memset(acc_re, 0, sizeof(acc_re));
            memset(acc_im, 0, sizeof(acc_im));
            for (int r = 0; r < ROWS; ++r)
                for (int i = 0; i < CI; ++i) {
                    const double* __restrict ar = adft_re[i][r];
                    const double* __restrict ai = adft_im[i][r];
                    const double* __restrict pr = PREP->re[r][i][co][l];
                    const double* __restrict pi = PREP->im[r][i][co][l];
                    for (int j = 0; j < M; ++j) {
                        acc_re[j] += ar[j] * pr[j] - ai[j] * pi[j];
                        acc_im[j] += ar[j] * pi[j] + ai[j] * pr[j];
                    }
                }
            inv_transform(acc_re, acc_im, big[l]);
        }
        big_normalize(big, RES[co]);
    }
}

// ---------------------------------------------------------------------------
// Exact oracle (i128 negacyclic convolution) for the pre-timing check
// ---------------------------------------------------------------------------

static void oracle_product(int64_t res[CO][RES_SIZE][N]) {
    static __int128 acc[PSIZE][N];
    static int64_t bigx[PSIZE][N];
    for (int co = 0; co < CO; ++co) {
        memset(acc, 0, sizeof(acc));
        for (int l = 0; l < PSIZE; ++l)
            for (int r = 0; r < ROWS; ++r)
                for (int i = 0; i < CI; ++i)
                    for (int x = 0; x < N; ++x) {
                        int64_t av = A[i][r][x];
                        if (!av) continue;
                        const int64_t* pv = PM[r][i][co][l];
                        for (int y = 0; y < N; ++y) {
                            __int128 p = (__int128)av * pv[y];
                            int k = x + y;
                            if (k < N) acc[l][k] += p;
                            else       acc[l][k - N] -= p;
                        }
                    }
        for (int l = 0; l < PSIZE; ++l)
            for (int x = 0; x < N; ++x) bigx[l][x] = (int64_t)acc[l][x];
        big_normalize(bigx, res[co]);
    }
}

// ---------------------------------------------------------------------------

static uint64_t rng_state = 0x9E3779B97F4A7C15ull;
static int64_t rnd_limb() {  // splitmix64 -> signed 17-bit-ish limb
    uint64_t z = (rng_state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    z = z ^ (z >> 31);
    return (int64_t)(z % 131072) - 65536;  // [-2^16, 2^16)
}

int main(int argc, char** argv) {
    double budget_s = argc > 1 ? atof(argv[1]) : 3.0;
    build_tables();
    PREP = new Prepared;
    for (int i = 0; i < CI; ++i)
        for (int r = 0; r < SIZE_A; ++r)
            for (int x = 0; x < N; ++x) A[i][r][x] = rnd_limb();
    for (int r = 0; r < ROWS; ++r)
        for (int i = 0; i < CI; ++i)
            for (int co = 0; co < CO; ++co)
                for (int l = 0; l < PSIZE; ++l) {
                    for (int x = 0; x < N; ++x) PM[r][i][co][l][x] = rnd_limb();
                    fwd_transform(PM[r][i][co][l],
                                  PREP->re[r][i][co][l],
                                  PREP->im[r][i][co][l]);
                }

    // correctness gate: FFT path must match the exact oracle bit-for-bit
    static int64_t want[CO][RES_SIZE][N];
    oracle_product(want);
    external_product();
    for (int co = 0; co < CO; ++co)
        for (int l = 0; l < RES_SIZE; ++l)
            for (int x = 0; x < N; ++x)
                if (RES[co][l][x] != want[co][l][x]) {
                    fprintf(stderr,
                            "MISMATCH co=%d l=%d x=%d have=%lld want=%lld\n",
                            co, l, x, (long long)RES[co][l][x],
                            (long long)want[co][l][x]);
                    return 1;
                }

    // calibrate then time
    using clk = std::chrono::steady_clock;
    long iters = 256;
    for (;;) {
        auto t0 = clk::now();
        for (long it = 0; it < iters; ++it) external_product();
        double dt = std::chrono::duration<double>(clk::now() - t0).count();
        if (dt >= budget_s || iters > (1L << 30)) {
            printf("{\"metric\": \"cpu_fft64_ext_products_per_s_1thread\", "
                   "\"value\": %.1f, \"unit\": \"ext-products/s\", "
                   "\"iters\": %ld, \"seconds\": %.3f}\n",
                   iters / dt, iters, dt);
            break;
        }
        iters = (long)(iters * (budget_s * 1.2 / dt)) + 1;
    }
    delete PREP;
    return 0;
}
